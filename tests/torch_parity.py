"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: seeded numpy inputs, conversions, and the mask comparison that
tolerates near-ties of the k-th score."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch import tree

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def as_jax(x: np.ndarray, dtype=jnp.float32):
    return jnp.asarray(x, jnp.float32).astype(dtype)


def as_torch(x: np.ndarray, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def np32(x) -> np.ndarray:
    """JAX array or tensor -> float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def jax_tree(np_tree):
    return jax.tree_util.tree_map(jnp.asarray, np_tree)


def torch_tree(np_tree):
    return tree.tree_map(lambda x: torch.from_numpy(np.array(x)), np_tree)


def assert_trees_close(got_torch, want_jax, rtol, atol):
    got = tree.leaves(got_torch)
    want = jax.tree_util.tree_leaves(want_jax)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(np32(g), np32(w), rtol=rtol, atol=atol)


def assert_masks_match(got, want, scores, keep, rel=1e-5):
    """(N, C) 0/1 masks must be equal, except at channels whose score lies
    within ``rel`` of the k-th largest score of their row (a near-tie the
    two packages may break differently)."""
    got, want, scores = np.asarray(got), np.asarray(want), np.asarray(scores)
    for i in np.flatnonzero((got != want).any(axis=1)):
        k = int(keep[i])
        kth = np.sort(scores[i])[::-1][max(k - 1, 0)]
        for c in np.flatnonzero(got[i] != want[i]):
            assert abs(scores[i, c] - kth) <= rel * max(abs(kth), 1e-30), (
                f"mask differs at client {i} channel {c}, score "
                f"{scores[i, c]} vs k-th {kth}")
