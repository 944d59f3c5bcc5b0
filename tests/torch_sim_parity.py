"""Fixtures shared by the tests that hold the port's simulator, fault
layer, population serving and crash-resume against the JAX package: one
small model's parameters drawn with numpy, the telemetry, and a
pseudo-trainer whose perturbation is a numpy draw keyed on the training
key's bits (the two packages' keys are equal bit for bit), so both
packages train identically without a dataset."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.allocation import ClientTelemetry as JaxTelemetry
from repro_torch import tree
from repro_torch.core.allocation import ClientTelemetry


def np_params(seed: int = 0, width: int = 12):
    """The fixture model {fc0: (20, width), fc1: (width, 5)} as numpy."""
    rng = np.random.default_rng(seed)
    return {"fc0": {"w": rng.normal(size=(20, width)).astype(np.float32),
                    "b": np.zeros(width, np.float32)},
            "fc1": {"w": rng.normal(size=(width, 5)).astype(np.float32),
                    "b": np.zeros(5, np.float32)}}


def np_sub_params(seed: int, width: int, full: int = 12):
    """A HeteroFL sub-model: the leading ``width`` hidden channels of
    :func:`np_params` at ``full``."""
    p = np_params(seed, full)
    return {"fc0": {"w": p["fc0"]["w"][:, :width].copy(),
                    "b": p["fc0"]["b"][:width].copy()},
            "fc1": {"w": p["fc1"]["w"][:width].copy(),
                    "b": p["fc1"]["b"].copy()}}


def t_params(np_tree):
    return tree.tree_map(lambda x: torch.from_numpy(np.array(x)), np_tree)


def j_params(np_tree):
    return jax.tree_util.tree_map(jnp.asarray, np_tree)


def nbytes(np_tree) -> float:
    return float(sum(np.asarray(l).nbytes for l in tree.leaves(np_tree)))


def telemetry(n: int, seed: int = 0, model_bytes=None, jax_side=False):
    """Per-client rates/latencies drawn with numpy (the reference's test
    fixture); ``jax_side`` builds the JAX package's dataclass."""
    rng = np.random.default_rng(seed)
    mb = (np.full(n, nbytes(np_params())) if model_bytes is None
          else np.asarray(model_bytes, float))
    cls = JaxTelemetry if jax_side else ClientTelemetry
    return cls(model_bytes=mb,
               uplink_rate=rng.uniform(1e3, 5e3, n),
               downlink_rate=rng.uniform(5e3, 2e4, n),
               compute_latency=rng.uniform(1.0, 5.0, n),
               num_samples=rng.integers(10, 50, n).astype(float),
               label_coverage=rng.uniform(0.5, 1.0, n),
               train_loss=np.ones(n))


def _noise(key, shapes):
    rng = np.random.default_rng(np.asarray(key).astype(np.uint32).tolist())
    return [rng.normal(0.0, 0.01, s).astype(np.float32) for s in shapes]


def ltf_torch(p, i, key):
    """Port trainer: ``0.99 x + noise(key)`` per leaf, loss 1/(i+1)."""
    leaves, td = tree.flatten(p)
    noise = _noise(key, [tuple(l.shape) for l in leaves])
    return tree.unflatten(td, [l * 0.99 + torch.from_numpy(z).to(l.device)
                               for l, z in zip(leaves, noise)]), \
        1.0 / (i + 1.0)


def ltf_jax(p, i, key):
    """The JAX package's twin of :func:`ltf_torch`."""
    leaves, td = jax.tree_util.tree_flatten(p)
    noise = _noise(key, [tuple(l.shape) for l in leaves])
    return jax.tree_util.tree_unflatten(
        td, [l * 0.99 + jnp.asarray(z) for l, z in zip(leaves, noise)]), \
        1.0 / (i + 1.0)


def trees_equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def assert_close_to_jax(got_torch, want_jax, atol):
    got = tree.leaves(got_torch)
    want = jax.tree_util.tree_leaves(want_jax)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().cpu().numpy(), np.asarray(w),
                                   rtol=0, atol=atol)
