"""The port's sparse collectives (``repro_torch.core.sparse_collective``)
against the JAX package and a float64 numpy oracle.

* ``compact_topk`` and ``scatter_accumulate`` equal the JAX package's
  functions (ties keep the lower index, as ``lax.top_k``; duplicate
  indices add);
* over a mesh of virtual CPU shards, the compacted (num, den) reduction
  and ``sparse_allgather_mean`` hold the float64 oracle of
  ``tests/test_sparse_collective.py``: lossless (overflow 0), lossy
  (overflow counts the channels that missed), ragged ``k_local``, keep 1
  -> the dense sum, the ceil buffer sizing, the bad-fraction errors;
* every result comes back once per shard, the same tensor on a virtual
  mesh (nothing copied), and two runs are bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_collective as jsc
from repro_torch.core import sparse_collective as sc
from repro_torch.launch.mesh import ClientMesh

P, C, F = 4, 8, 5


def _mesh(p=P):
    return ClientMesh((torch.device("cpu"),) * p)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _oracle(num, den):
    return (np.sum(np.asarray(num, np.float64), axis=0).astype(np.float32),
            np.sum(np.asarray(den, np.float64), axis=0).astype(np.float32))


def _reduce(num, den, k, k_local=None, mesh=None):
    mesh = mesh or _mesh(num.shape[0])
    return sc.sparse_numden_allreduce(
        [_t(x) for x in num], [_t(x) for x in den], k, mesh,
        k_local=k_local)


@pytest.mark.parametrize("scores", [
    [0.1, 5.0, 0.0, 3.0, 4.0, 0.2],
    [1.0, 0.0, 1.0, 0.0, 1.0, 1.0],          # ties: the lower index first
    [0.0] * 6])
def test_compact_topk_equals_jax_package(scores):
    vals = np.arange(24.0, dtype=np.float32).reshape(6, 4)
    s = np.asarray(scores, np.float32)
    for k in (1, 3, 6):
        got_v, got_i = sc.compact_topk(_t(vals), _t(s), k)
        want_v, want_i = jsc.compact_topk(jnp.asarray(vals), jnp.asarray(s),
                                          k)
        assert got_i.dtype == torch.int32
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_scatter_accumulate_equals_jax_package():
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(8, 5)).astype(np.float32)
    scores = rng.uniform(1.0, 2.0, 8).astype(np.float32)
    compact, idx = sc.compact_topk(_t(dense), _t(scores), 8)
    num, cnt = sc.scatter_accumulate(dense.shape, compact, idx, 2.0)
    np.testing.assert_allclose(num.numpy(), 2.0 * dense, rtol=1e-6)
    np.testing.assert_allclose(cnt.numpy(), np.full(8, 2.0))
    # duplicate indices add
    w = np.asarray([1.0, 2.0, 4.0], np.float32)
    idx = np.asarray([1, 1, 2], np.int32)
    got = sc.scatter_accumulate((4, 2), torch.ones(3, 2), _t(idx), _t(w))
    want = jsc.scatter_accumulate((4, 2), jnp.ones((3, 2)), jnp.asarray(idx),
                                  jnp.asarray(w))
    for g, wn in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wn))


def test_numden_lossless_matches_oracle_and_replicates():
    """Each shard keeps <= 3 of 8 channels, buffer 4: the oracle's mass,
    overflow 0, uniform and ragged sparsity; one result per shard, the
    same tensor on a virtual mesh; two runs bit-equal."""
    rng = np.random.default_rng(7)
    num = np.zeros((P, C, F), np.float32)
    den = np.zeros((P, C), np.float32)
    for s in range(P):
        keep = rng.choice(C, size=rng.integers(1, 4), replace=False)
        den[s, keep] = rng.uniform(0.5, 2.0, keep.size)
        num[s, keep] = rng.normal(size=(keep.size, F)) * den[s, keep][:, None]
    n_tot, d_tot, ovf = _reduce(num, den, 4)
    assert len(n_tot) == len(d_tot) == len(ovf) == P
    assert all(x is n_tot[0] for x in n_tot)
    assert float(ovf[0]) == 0.0
    on, od = _oracle(num, den)
    np.testing.assert_allclose(n_tot[0].numpy(), on, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_tot[0].numpy(), od, rtol=1e-5, atol=1e-6)
    again = _reduce(num, den, 4)
    assert torch.equal(again[0][0], n_tot[0])
    assert torch.equal(again[1][0], d_tot[0])


def test_numden_overflow_certifies_lossy_compaction():
    rng = np.random.default_rng(7)
    num = rng.normal(size=(P, C, F)).astype(np.float32)
    den = np.ones((P, C), np.float32)            # every channel nonzero
    n_tot, d_tot, ovf = _reduce(num, den, 3)
    assert float(ovf[0]) == P * (C - 3)
    assert not np.allclose(d_tot[0].numpy(), _oracle(num, den)[1])


def test_ragged_k_local_zeroes_rows_past_each_shards_count():
    rng = np.random.default_rng(7)
    k = 4
    num = rng.normal(size=(P, C, F)).astype(np.float32)
    den = rng.uniform(0.5, 2.0, size=(P, C)).astype(np.float32)
    k_locals = [1 + (s % k) for s in range(P)]
    n_tot, d_tot, _ = _reduce(num, den, k,
                              k_local=[torch.tensor(x) for x in k_locals])
    on = np.zeros((C, F), np.float64)
    od = np.zeros((C,), np.float64)
    for s in range(P):
        keep = np.argsort(-den[s], kind="stable")[:k_locals[s]]
        on[keep] += num[s, keep]
        od[keep] += den[s, keep]
    np.testing.assert_allclose(n_tot[0].numpy(), on.astype(np.float32),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_tot[0].numpy(), od.astype(np.float32),
                               rtol=1e-5, atol=1e-6)


def test_keep_fraction_one_is_the_dense_sum_and_ceil_sizing():
    rng = np.random.default_rng(7)
    num = rng.normal(size=(P, C, F)).astype(np.float32)
    den = rng.uniform(0.0, 2.0, size=(P, C)).astype(np.float32)
    f = sc.make_federated_numden_allreduce(1.0, _mesh())
    n_tot, d_tot, ovf = f([_t(x) for x in num], [_t(x) for x in den])
    on, od = _oracle(num, den)
    assert float(ovf[0]) == 0.0
    np.testing.assert_allclose(n_tot[0].numpy(), on, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d_tot[0].numpy(), od, rtol=1e-6, atol=1e-6)
    # keep 0.5: a buffer of ceil(8 * 0.5) = 4 channels, exactly what each
    # shard holds -> lossless; 5 would overflow by one per shard
    f = sc.make_federated_numden_allreduce(0.5, _mesh())
    for held, want_ovf in ((4, 0.0), (5, float(P))):
        num = np.zeros((P, C, F), np.float32)
        den = np.zeros((P, C), np.float32)
        for s in range(P):
            keep = rng.choice(C, size=held, replace=False)
            den[s, keep] = 1.0
            num[s, keep] = rng.normal(size=(held, F))
        n_tot, _, ovf = f([_t(x) for x in num], [_t(x) for x in den])
        assert float(ovf[0]) == want_ovf
        if not want_ovf:
            np.testing.assert_allclose(n_tot[0].numpy(), _oracle(num, den)[0],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("frac", [0.0, 1.5, -0.1])
def test_bad_fractions_raise(frac):
    with pytest.raises(ValueError, match="keep_fraction"):
        sc.make_federated_numden_allreduce(frac, _mesh())
    with pytest.raises(ValueError, match="k_fraction"):
        sc.make_federated_allreduce(frac, _mesh())


def test_allgather_mean_and_dense_mean_match_oracle():
    """sparse_allgather_mean: each shard's top-k channels by score at its
    weight, the weighted mean where anyone contributed and each shard's own
    local value elsewhere; the dense route (k_fraction 1) and
    dense_allreduce_mean: the weighted dense mean."""
    rng = np.random.default_rng(3)
    loc = rng.normal(size=(P, C, F)).astype(np.float32)
    scores = rng.uniform(size=(P, C)).astype(np.float32)
    w = [1.0, 2.0, 3.0, 4.0]
    k = 2
    got = sc.sparse_allgather_mean([_t(x) for x in loc],
                                   [_t(x) for x in scores], k, _mesh(),
                                   weight=w, k_local=[2, 1, 2, 0])
    num = np.zeros((C, F))
    cnt = np.zeros(C)
    for s, kl in enumerate([2, 1, 2, 0]):
        keep = np.argsort(-scores[s], kind="stable")[:kl]
        num[keep] += loc[s, keep] * w[s]
        cnt[keep] += w[s]
    for s in range(P):
        want = np.where(cnt[:, None] > 0, num / np.maximum(cnt, 1e-12)[:, None],
                        loc[s])
        np.testing.assert_allclose(got[s].numpy(), want, rtol=1e-5,
                                   atol=1e-6)
    dense = sc.make_federated_allreduce(1.0, _mesh())(
        [_t(x) for x in loc], [_t(x) for x in scores], weight=w)
    want = np.tensordot(np.asarray(w), loc.astype(np.float64), 1) / sum(w)
    for d in dense:
        np.testing.assert_allclose(d.numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="per-shard"):
        sc.dense_allreduce_mean([_t(loc[0])], _mesh())
