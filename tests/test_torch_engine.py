"""One BatchedRoundEngine step of the PyTorch port against the JAX engine.

The same seeded inputs — the paper's MLP at full width, N=10 clients, one
client with aggregation weight 0 — go through both engines, for a
partial and a full (Eq. (6)) round, with FedDD masks and with FedAvg's
all-ones masks.  The JAX engine runs with ``use_kernel`` False (jnp) and
True (Pallas, interpret mode); the port runs its kernels' plain versions.
Densities agree to rtol 1e-6, masks exactly (up to near-ties of the k-th
score), parameters to rtol 1e-5 / atol 1e-6 (float32 sums in another
order).

With the round key and a wire format (codec x qbits, schemes feddd,
random and FedAvg's dense masks): densities, the measured wire overhead,
random masks and the quantize-dequantized uploads the aggregation reads
are equal; parameters within the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import quantize as jax_quant
from repro.comm.payload import CommConfig as JaxComm
from repro.core import round_engine as jax_engine
from repro.core import selection as jax_sel
from repro_torch import tree
from repro_torch.comm import CommConfig
from repro_torch.comm import quantize
from repro_torch.core import round_engine, selection

from torch_parity import (assert_masks_match, assert_trees_close, jax_tree,
                          np32, torch_tree)

N = 10
SHAPES = {"fc0": {"w": (784, 100), "b": (100,)},
          "fc1": {"w": (100, 64), "b": (64,)},
          "fc2": {"w": (64, 10), "b": (10,)}}


def _inputs():
    rng = np.random.default_rng(11)
    gp = {k: {p: (rng.normal(size=s) / 8).astype(np.float32)
              for p, s in v.items()} for k, v in SHAPES.items()}
    old = jax.tree_util.tree_map(
        lambda g: (g + 0.05 * rng.normal(size=(N,) + g.shape)
                   ).astype(np.float32), gp)
    new = jax.tree_util.tree_map(
        lambda o: (o + 0.02 * rng.normal(size=o.shape)).astype(np.float32),
        old)
    rates = rng.uniform(0.0, 0.8, N)
    weights = rng.integers(100, 900, N).astype(float)
    weights[3] = 0.0
    return gp, old, new, rates, weights


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dense_masks", [False, True])
@pytest.mark.parametrize("full_round", [False, True])
def test_engine_step_matches_jax(full_round, dense_masks, use_kernel):
    gp, old, new, rates, weights = _inputs()
    jcfg = jax_sel.SelectionConfig(use_kernel=use_kernel)
    want = jax_engine.BatchedRoundEngine(jcfg).step(
        jax_tree(old), jax_tree(new), jax_tree(gp), rates, weights,
        jax.random.PRNGKey(0), full_round=full_round,
        dense_masks=dense_masks)
    got = round_engine.BatchedRoundEngine().step(
        torch_tree(old), torch_tree(new), torch_tree(gp), rates, weights,
        full_round=full_round, dense_masks=dense_masks)
    np.testing.assert_allclose(got.densities.numpy(),
                               np.asarray(want.densities), rtol=1e-6)
    assert_trees_close(got.global_params, want.global_params, rtol=1e-5,
                       atol=1e-6)
    assert_trees_close(got.client_params, want.client_params, rtol=1e-5,
                       atol=1e-6)
    for leaf in tree.leaves(got.client_params):
        assert leaf.is_contiguous()
    if not dense_masks:   # the masks the step used, built the same way
        jm, _ = jax_sel.build_masks_batched(
            jax_tree(old), jax_tree(new), jnp.asarray(rates, jnp.float32),
            config=jcfg)
        tm, _ = selection.build_masks_batched(torch_tree(old),
                                              torch_tree(new), rates)
        for t, j, o, w in zip(tree.leaves(tm),
                              jax.tree_util.tree_leaves(jm),
                              jax.tree_util.tree_leaves(jax_tree(old)),
                              jax.tree_util.tree_leaves(jax_tree(new))):
            c = j.shape[-1]
            scores = np32(jax_sel._tensor_scores_batched(jcfg, o, w, None))
            keep = np.asarray(jax_sel.keep_count(
                c, jnp.asarray(rates, jnp.float32)))
            assert_masks_match(np32(t).reshape(N, c), np32(j).reshape(N, c),
                               scores, keep)


def test_stack_and_unstack_roundtrip():
    _, old, _, _, _ = _inputs()
    stacked = torch_tree(old)
    parts = round_engine.unstack_pytree(stacked, N)
    back = round_engine.stack_pytrees(parts)
    for a, b in zip(tree.leaves(stacked), tree.leaves(back)):
        assert torch.equal(a, b)
    want = jax_engine.unstack_pytree(jax_tree(old), N)
    for got_i, want_i in zip(parts, want):
        assert_trees_close(got_i, want_i, rtol=0, atol=0)


@pytest.mark.parametrize("qbits", [32, 16, 8])
@pytest.mark.parametrize("codec", ["dense", "bitmask", "index", "auto"])
@pytest.mark.parametrize("scheme", ["feddd", "random", "fedavg"])
def test_engine_step_with_round_key_and_wire_format_matches_jax(
        scheme, codec, qbits):
    gp, old, new, rates, weights = _inputs()
    rk = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    dense = scheme == "fedavg"
    sel = "feddd" if dense else scheme
    want = jax_engine.BatchedRoundEngine(
        jax_sel.SelectionConfig(scheme=sel),
        JaxComm(codec=codec, qbits=qbits)).step(
        jax_tree(old), jax_tree(new), jax_tree(gp), rates, weights, rk,
        full_round=False, dense_masks=dense)
    got = round_engine.BatchedRoundEngine(
        selection.SelectionConfig(scheme=sel),
        CommConfig(codec=codec, qbits=qbits)).step(
        torch_tree(old), torch_tree(new), torch_tree(gp), rates, weights,
        np.asarray(rk), full_round=False, dense_masks=dense)
    np.testing.assert_array_equal(got.densities.numpy(),
                                  np.asarray(want.densities))
    if codec == "dense" and qbits == 32:
        assert got.wire_overhead is None and want.wire_overhead is None
    else:
        assert got.wire_overhead.dtype == torch.int32
        np.testing.assert_array_equal(got.wire_overhead.numpy(),
                                      np.asarray(want.wire_overhead))
    assert_trees_close(got.global_params, want.global_params, rtol=1e-5,
                       atol=1e-6)
    assert_trees_close(got.client_params, want.client_params, rtol=1e-5,
                       atol=1e-6)
    if scheme == "random":
        jm, _ = jax_sel.build_masks_batched(
            jax_tree(old), jax_tree(new), jnp.asarray(rates, jnp.float32),
            config=jax_sel.SelectionConfig(scheme="random"), rng=rk)
        tm, _ = selection.build_masks_batched(
            torch_tree(old), torch_tree(new), rates,
            config=selection.SelectionConfig(scheme="random"),
            rng=np.asarray(rk))
        for t, j in zip(tree.leaves(tm), jax.tree_util.tree_leaves(jm)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if qbits < 32:     # what the aggregation read
        jq = jax.jit(lambda s, k: jax_quant.quantize_dequantize_stacked(
            s, k, qbits))(jax_tree(new), rk)
        tq = quantize.quantize_dequantize_stacked(torch_tree(new),
                                                  np.asarray(rk), qbits)
        for t, j in zip(tree.leaves(tq), jax.tree_util.tree_leaves(jq)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_random_scheme_and_int8_need_the_round_key():
    gp, old, new, rates, weights = _inputs()
    with pytest.raises(ValueError, match="rng"):
        round_engine.BatchedRoundEngine(
            selection.SelectionConfig(scheme="random")).step(
            torch_tree(old), torch_tree(new), torch_tree(gp), rates,
            weights, full_round=False)
    with pytest.raises(ValueError, match="PRNG key"):
        round_engine.BatchedRoundEngine(comm=CommConfig(qbits=8)).step(
            torch_tree(old), torch_tree(new), torch_tree(gp), rates,
            weights, full_round=False)
