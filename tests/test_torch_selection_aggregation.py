"""Algorithm 2 masks, Eq. (4)-(6) and the Eq. (9)-(11) allocator of the
PyTorch port, held against the JAX package on the same seeded inputs.

Masks must be equal except at channels whose score lies within 1e-5 of
the k-th score (a near-tie the packages may break differently); densities
agree to rtol 1e-6; the numpy allocator's rates are exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jax_agg
from repro.core import allocation as jax_alloc
from repro.core import selection as jax_sel
from repro_torch import tree
from repro_torch.core import aggregation, allocation, selection

from torch_parity import (as_jax, as_torch, assert_masks_match,
                          assert_trees_close, jax_tree, np32, torch_tree)

MLP_SHAPES = {"fc0": {"w": (784, 100), "b": (100,)},
              "fc1": {"w": (100, 64), "b": (64,)},
              "fc2": {"w": (64, 10), "b": (10,)}}


def _stacked(rng, n, shapes=MLP_SHAPES, scale=0.05):
    """(old, new) numpy pytrees of client-stacked leaves."""
    old = {k: {p: rng.normal(size=(n,) + s).astype(np.float32)
               for p, s in v.items()} for k, v in shapes.items()}
    new = {k: {p: (x + scale * rng.normal(size=x.shape)).astype(np.float32)
               for p, x in v.items()} for k, v in old.items()}
    return old, new


@pytest.mark.parametrize("scheme,use_kernel,dtype", [
    ("feddd", False, "float32"), ("feddd", True, "float32"),
    ("feddd", True, "bfloat16"), ("max", False, "float32"),
    ("delta", False, "float32"), ("ordered", False, "float32")])
def test_build_masks_batched_matches_jax(scheme, use_kernel, dtype):
    n = 6
    rng = np.random.default_rng(7)
    old, new = _stacked(rng, n)
    rates = np.concatenate([[0.0, 0.8], rng.uniform(0, 0.8, n - 2)])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cast_j = lambda t: jax.tree_util.tree_map(lambda x: as_jax(x, jdt), t)  # noqa
    cast_t = lambda t: tree.tree_map(lambda x: as_torch(x, tdt), t)  # noqa
    jcfg = jax_sel.SelectionConfig(scheme=scheme, use_kernel=use_kernel)
    jmasks, jdens = jax_sel.build_masks_batched(
        cast_j(old), cast_j(new), jnp.asarray(rates, jnp.float32),
        config=jcfg)
    tmasks, tdens = selection.build_masks_batched(
        cast_t(old), cast_t(new), rates,
        config=selection.SelectionConfig(scheme=scheme))
    np.testing.assert_allclose(tdens.numpy(), np.asarray(jdens), rtol=1e-6)
    for (tm, jm, wo, wn) in zip(tree.leaves(tmasks),
                                jax.tree_util.tree_leaves(jmasks),
                                jax.tree_util.tree_leaves(cast_j(old)),
                                jax.tree_util.tree_leaves(cast_j(new))):
        assert tuple(tm.shape) == tuple(jm.shape) and tm.dtype == tdt
        c = jm.shape[-1]
        scores = np32(jax_sel._tensor_scores_batched(jcfg, wo, wn, None))
        keep = np.asarray(jax_sel.keep_count(c, jnp.asarray(rates,
                                                            jnp.float32)))
        assert_masks_match(np32(tm).reshape(n, c), np32(jm).reshape(n, c),
                           scores, keep)


def test_mask_ties_keep_the_lower_index():
    """lax.top_k breaks ties toward the lower index; so must the port."""
    scores = np.array([[1, 2, 2, 2, 1, 3, 3, 0],
                       [5, 5, 5, 5, 5, 5, 5, 5],
                       [0, 1, 0, 1, 0, 1, 0, 1]], np.float32)
    keep = np.array([4, 3, 5], np.int32)
    got = selection.mask_from_scores(torch.from_numpy(scores),
                                     torch.from_numpy(keep), 8).numpy()
    want = np.asarray(jax.vmap(jax_sel.mask_from_scores, (0, 0, None))(
        jnp.asarray(scores), jnp.asarray(keep), 8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0, 1, 1, 0, 0, 1, 1, 0],
                                        [1, 1, 1, 0, 0, 0, 0, 0],
                                        [1, 1, 0, 1, 0, 1, 0, 1]])
    for k in (0, 8):
        row = selection.mask_from_scores(torch.from_numpy(scores[0]),
                                         torch.tensor(k), 8).numpy()
        np.testing.assert_array_equal(row, np.full(8, float(k > 0)))


def test_keep_count_is_float32_ceil_like_jax():
    rates = np.concatenate([np.linspace(0, 1, 101),
                            [0.3, 0.7, 0.8, 0.1, 0.2, 0.9, 1e-7]])
    rates = rates.astype(np.float32)
    for c in (1, 3, 7, 10, 64, 100, 784, 4096):
        got = selection.keep_count(c, torch.from_numpy(rates)).numpy()
        want = np.asarray(jax_sel.keep_count(c, jnp.asarray(rates)))
        np.testing.assert_array_equal(got, want)


def _agg_inputs(rng, n):
    shapes = {"a": {"w": (12, 9), "b": (9,)}, "c": {"w": (3, 3, 2, 5)}}
    vals, _ = _stacked(rng, n, shapes)
    masks = jax.tree_util.tree_map(
        lambda x: (rng.uniform(size=(n,) + (1,) * (x.ndim - 2)
                              + x.shape[-1:]) > 0.5).astype(np.float32),
        vals)
    for m in jax.tree_util.tree_leaves(masks):
        m[..., 0] = 0.0                  # a channel no client uploads
    gprev = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape[1:]).astype(np.float32), vals)
    weights = rng.integers(10, 100, n).astype(float)
    weights[1] = 0.0                     # a client left out of Eq. (4)
    return vals, masks, gprev, weights


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_aggregate_sparse_stacked_matches_jax(with_prev, use_kernel):
    vals, masks, gprev, weights = _agg_inputs(np.random.default_rng(3), 5)
    want = jax_agg.aggregate_sparse_stacked(
        jax_tree(vals), jax_tree(masks), weights,
        prev_global=jax_tree(gprev) if with_prev else None,
        use_kernel=use_kernel)
    got = aggregation.aggregate_sparse_stacked(
        torch_tree(vals), torch_tree(masks), weights,
        prev_global=torch_tree(gprev) if with_prev else None)
    assert_trees_close(got, want, rtol=1e-5, atol=1e-6)
    if with_prev:   # the never-uploaded channel keeps the previous global
        for g, p in zip(tree.leaves(got), jax.tree_util.tree_leaves(gprev)):
            np.testing.assert_array_equal(g.numpy()[..., 0], p[..., 0])


def test_client_updates_and_fedavg_match_jax():
    rng = np.random.default_rng(5)
    vals, masks, gprev, weights = _agg_inputs(rng, 4)
    got = aggregation.client_update_sparse(torch_tree(gprev),
                                           torch_tree(vals),
                                           torch_tree(masks))
    want = jax_agg.client_update_sparse(jax_tree(gprev), jax_tree(vals),
                                        jax_tree(masks))
    assert_trees_close(got, want, rtol=0, atol=0)
    full = aggregation.client_update_full(torch_tree(gprev),
                                          torch_tree(vals))
    assert_trees_close(full, jax_agg.client_update_full(jax_tree(gprev),
                                                        jax_tree(vals)),
                       rtol=0, atol=0)
    clients = [jax.tree_util.tree_map(lambda x: x[i], vals)
               for i in range(4)]
    w = [3.0, 1.0, 2.0, 5.0]
    assert_trees_close(
        aggregation.fedavg_aggregate([torch_tree(c) for c in clients], w),
        jax_agg.fedavg_aggregate([jax_tree(c) for c in clients], w),
        rtol=1e-6, atol=1e-7)


def test_unported_aggregation_variants_raise():
    """The robust variants are ported (tests/test_torch_robust.py); a
    variant the JAX package does not have raises, as there."""
    vals, masks, _, weights = _agg_inputs(np.random.default_rng(0), 3)
    for spec in ("krum", "median", "mean:0.1"):
        with pytest.raises(ValueError, match="robust_agg"):
            aggregation.aggregate_sparse_stacked(
                torch_tree(vals), torch_tree(masks), weights, robust=spec)


def _telemetry(cls, seed, n):
    rng = np.random.default_rng(seed)
    return cls(model_bytes=rng.choice([1e5, 3e5, 8e5], n),
               uplink_rate=rng.uniform(1e3, 7e3, n),
               downlink_rate=rng.uniform(5e3, 3e4, n),
               compute_latency=rng.uniform(1, 30, n),
               num_samples=rng.integers(50, 900, n).astype(float),
               label_coverage=rng.uniform(1, 3, n),
               train_loss=rng.uniform(0.05, 2.5, n))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("a_server", [0.3, 0.6, 0.9])
def test_numpy_allocator_rates_equal_jax_package(seed, a_server):
    n = 12 + seed
    kw = dict(a_server=a_server, d_max=0.8, delta=1.0,
              global_model_bytes=8e5)
    got = allocation.solve_dropout_rates_with(
        "numpy", _telemetry(allocation.ClientTelemetry, seed, n), **kw)
    want = jax_alloc.solve_dropout_rates(
        _telemetry(jax_alloc.ClientTelemetry, seed, n), **kw)
    np.testing.assert_array_equal(got.dropout_rates, want.dropout_rates)
    assert got.t_server == want.t_server
    assert got.objective == want.objective
    assert got.feasible == want.feasible
    with pytest.raises(ValueError, match="unknown allocator"):
        allocation.solve_dropout_rates_with(
            "scipy", _telemetry(allocation.ClientTelemetry, seed, n), **kw)
