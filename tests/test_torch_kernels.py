"""The port's kernels, held against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels run
as tests/test_kernels.py runs them (``repro.kernels.*.ops``, interpret mode)
and beside them the JAX ``ref.py`` oracles.  Inputs are seeded numpy
arrays, cast to each dtype the same way (round to nearest even) in both
packages.  Tolerances are those of tests/test_kernels.py: importance rtol
5e-5 / atol 1e-5, Eq. (4) num rtol 3e-5 (fp32) or 5e-3 (bf16) with atol
1e-4, den rtol 3e-5 / atol 1e-5, Eq. (5) exact.
"""

import numpy as np
import pytest
import torch

from repro.core import aggregation as jax_agg
from repro.core import importance as jax_imp
from repro.kernels.importance import ops as jax_imp_ops
from repro.kernels.importance.ref import channel_importance_ref as jax_imp_ref
from repro.kernels.masked_merge import ops as jax_mm_ops
from repro.kernels.masked_merge.ref import masked_merge_ref as jax_mm_ref
from repro.kernels.sparse_agg import ops as jax_agg_ops
from repro.kernels.sparse_agg.ref import masked_weighted_sum_ref as jax_agg_ref
from repro_torch.kernels import launch_counts
from repro_torch.kernels.importance import ops as imp_ops
from repro_torch.kernels.masked_merge import ops as mm_ops
from repro_torch.kernels.sparse_agg import ops as agg_ops

from torch_parity import DTYPES, as_jax, as_torch, np32

SHAPES_2D = [(8, 16), (64, 128), (100, 300), (7, 1000), (1000, 7),
             (256, 512), (257, 513), (3, 3)]
NCF = [(2, 8, 16), (4, 64, 128), (7, 100, 300), (16, 33, 70),
       (32, 128, 256)]


def _ids(d):
    return d[0]


def _pair(rng, shape):
    wo = rng.normal(size=shape).astype(np.float32)
    wn = (wo + 0.1 * rng.normal(size=shape)).astype(np.float32)
    return wo, wn


@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_importance_matches_pallas(shape, dt):
    _, jdt, tdt = dt
    wo, wn = _pair(np.random.default_rng(sum(shape)), shape)
    jo, jn = as_jax(wo, jdt), as_jax(wn, jdt)
    got = imp_ops.channel_importance_batched(
        as_torch(wo, tdt)[None], as_torch(wn, tdt)[None], channel_axis=0)[0]
    want_kernel = jax_imp_ops.channel_importance(jo, jn, channel_axis=0)
    want_ref = jax_imp_ref(jo, jn)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(np32(got), np32(want), rtol=5e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("shape", [(10, 784, 100), (10, 100, 64), (10, 64),
                                   (3, 3, 3, 4, 8), (7, 257, 513)])
@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
@pytest.mark.parametrize("with_coverage", [False, True])
def test_importance_channel_last_matches_batched(shape, dt, with_coverage):
    """The main path's layout: (N, in, out) leaves, channel_axis=-1, read
    in place — against the JAX kernel's batched wrapper and, in fp32, the
    jnp scorer (which computes in the parameters' dtype, so for bf16
    inputs it rounds its scores to bf16 where the kernels keep fp32)."""
    _, jdt, tdt = dt
    rng = np.random.default_rng(len(shape) * 1000 + shape[-1])
    wo, wn = _pair(rng, shape)
    cov = (rng.uniform(0.2, 1.0, shape[-1]).astype(np.float32)
           if with_coverage else None)
    got = imp_ops.channel_importance_batched(
        as_torch(wo, tdt), as_torch(wn, tdt), channel_axis=-1,
        coverage=None if cov is None else torch.from_numpy(cov))
    jo, jn = as_jax(wo, jdt), as_jax(wn, jdt)
    jcov = None if cov is None else as_jax(cov)
    assert tuple(got.shape) == (shape[0], shape[-1])
    scorers = [jax_imp_ops.channel_importance_batched]
    if tdt == torch.float32:
        scorers.append(jax_imp.channel_importance_batched)
    for fn in scorers:
        want = fn(jo, jn, channel_axis=-1, coverage=jcov)
        np.testing.assert_allclose(np32(got), np32(want), rtol=5e-5,
                                   atol=1e-5)


def test_importance_epsilon_guard_matches():
    """Zero and tiny old weights hit the signed 1e-8 clamp identically."""
    wo = np.array([[0.0, -0.0, 1e-9, -1e-9, 2e-8, 0.5]], np.float32).T
    wn = np.array([[0.1, -0.2, 0.3, 0.4, -0.5, 0.6]], np.float32).T
    wo, wn = np.repeat(wo, 3, axis=1), np.repeat(wn, 3, axis=1)
    got = imp_ops.channel_importance_batched(
        as_torch(wo)[None], as_torch(wn)[None], channel_axis=0)[0]
    want = jax_imp_ops.channel_importance(as_jax(wo), as_jax(wn),
                                          channel_axis=0)
    np.testing.assert_allclose(np32(got), np32(want), rtol=5e-5, atol=1e-5)


@pytest.mark.parametrize("n,c,f", NCF)
@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_sparse_agg_matches_pallas(n, c, f, dt):
    """(N, C, F) values with an (N, C, 1) channel mask, as the JAX sweep."""
    _, jdt, tdt = dt
    rng = np.random.default_rng(n * 1000 + c)
    sw = rng.normal(size=(n, c, f)).astype(np.float32)
    sm = (rng.uniform(size=(n, c, 1)) > 0.5).astype(np.float32)
    wts = (rng.uniform(size=n) + 0.5).astype(np.float32)
    num, den = agg_ops.masked_weighted_sum(as_torch(sw, tdt),
                                           as_torch(sm, tdt),
                                           torch.from_numpy(wts))
    jw, jm = as_jax(sw, jdt), as_jax(sm, jdt)
    want_kernel = jax_agg_ops.masked_weighted_sum(jw, jm, as_jax(wts))
    want_ref = jax_agg_ref(jw, np.broadcast_to(np.asarray(jm), jw.shape),
                           as_jax(wts))
    rtol = 5e-3 if tdt == torch.bfloat16 else 3e-5
    for wnum, wden in (want_kernel, want_ref):
        np.testing.assert_allclose(np32(num), np32(wnum), rtol=rtol,
                                   atol=1e-4)
        np.testing.assert_allclose(np32(den), np32(wden), rtol=3e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("n,leaf", [(10, (784, 100)), (10, (64,)),
                                    (4, (3, 3, 2, 8))])
@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_sparse_agg_dense_and_channel_last_masks(n, leaf, dt):
    """FedAvg's all-ones (N, 1, ..., 1) masks (stride 0 in the kernel) and
    FedDD's channel-last (N, 1, ..., C) masks, against the JAX Eq. (4)
    partials the engine uses (aggregation.leaf_masked_partials)."""
    _, jdt, tdt = dt
    rng = np.random.default_rng(n + len(leaf))
    sw = rng.normal(size=(n,) + leaf).astype(np.float32)
    chan = (rng.uniform(size=(n,) + (1,) * (len(leaf) - 1) + leaf[-1:])
            > 0.4).astype(np.float32)
    dense = np.ones((n,) + (1,) * len(leaf), np.float32)
    wts = rng.integers(50, 500, n).astype(np.float32)
    rtol = 5e-3 if tdt == torch.bfloat16 else 3e-5
    for mask in (chan, dense):
        num, den = agg_ops.masked_weighted_sum(
            as_torch(sw, tdt), as_torch(mask, tdt), torch.from_numpy(wts))
        jw = as_jax(sw, jdt)
        jm = np.broadcast_to(np.asarray(as_jax(mask, jdt)), jw.shape)
        for use_kernel in (False, True):
            wnum, wden = jax_agg.leaf_masked_partials(jw, jm, as_jax(wts),
                                                      use_kernel=use_kernel)
            np.testing.assert_allclose(np32(num), np32(wnum), rtol=rtol,
                                       atol=1e-4)
            np.testing.assert_allclose(np32(den), np32(wden), rtol=3e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("c,f", [(8, 16), (64, 128), (100, 37), (7, 7),
                                 (300, 500)])
@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_masked_merge_matches_pallas(c, f, dt):
    """Eq. (5) with a binary channel mask is an exact select."""
    _, jdt, tdt = dt
    rng = np.random.default_rng(c * 100 + f)
    g = rng.normal(size=(c, f)).astype(np.float32)
    loc = rng.normal(size=(c, f)).astype(np.float32)
    m = (rng.uniform(size=c) > 0.5).astype(np.float32)
    got = mm_ops.masked_merge(as_torch(g, tdt), as_torch(loc, tdt)[None],
                              as_torch(m, tdt).view(1, c, 1))[0]
    jg, jl = as_jax(g, jdt), as_jax(loc, jdt)
    want_kernel = jax_mm_ops.masked_merge(jg, jl, as_jax(m), channel_axis=0)
    want_ref = jax_mm_ref(jg, jl, as_jax(m))
    for want in (want_kernel, want_ref):
        np.testing.assert_array_equal(np32(got), np32(want))
    sel = np.where(m[:, None] > 0, np32(jg), np32(jl))
    np.testing.assert_array_equal(np32(got), sel)


@pytest.mark.parametrize("n,leaf", [(10, (784, 100)), (10, (10,)),
                                    (3, (3, 3, 4, 8))])
@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_masked_merge_stacked_matches_client_update(n, leaf, dt):
    """Client-stacked (N, *leaf) with one global broadcast over N, against
    the JAX engine's inline Eq. (5) (aggregation.client_update_sparse)."""
    _, jdt, tdt = dt
    rng = np.random.default_rng(n * 7 + len(leaf))
    g = rng.normal(size=leaf).astype(np.float32)
    loc = rng.normal(size=(n,) + leaf).astype(np.float32)
    m = (rng.uniform(size=(n,) + (1,) * (len(leaf) - 1) + leaf[-1:])
         > 0.5).astype(np.float32)
    got = mm_ops.masked_merge(as_torch(g, tdt), as_torch(loc, tdt),
                              as_torch(m, tdt))
    assert got.dtype == tdt
    want = jax_agg.client_update_sparse(as_jax(g, jdt), as_jax(loc, jdt),
                                        as_jax(m, jdt))
    np.testing.assert_array_equal(np32(got), np32(want))


def test_cpu_tensors_never_count_as_launches():
    """The plain version serves CPU tensors; the launch counts only move
    where a kernel launches on the card."""
    before = launch_counts()
    x = torch.ones(2, 4, 3)
    imp_ops.channel_importance_batched(x, x * 2)
    agg_ops.masked_weighted_sum(x, torch.ones(2, 1, 3), torch.ones(2))
    mm_ops.masked_merge(x[0], x, torch.ones(2, 1, 3))
    assert launch_counts() == before


@pytest.mark.parametrize("case", ["noncontiguous", "dtype", "device",
                                  "mask_shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    x = torch.ones(2, 4, 3)
    m = torch.ones(2, 1, 3)
    w = torch.ones(2)
    if case == "noncontiguous":
        bad = torch.ones(2, 3, 4).transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            imp_ops.channel_importance_batched(bad, bad)
        with pytest.raises(ValueError, match="contiguous"):
            mm_ops.masked_merge(x[0], bad, m)
    elif case == "dtype":
        with pytest.raises(TypeError):
            imp_ops.channel_importance_batched(x.double(), x.double())
        with pytest.raises(TypeError):
            agg_ops.masked_weighted_sum(x, m.bfloat16(), w)
    elif case == "device":
        meta = x.to("meta")
        with pytest.raises(ValueError, match="no kernel for device"):
            imp_ops.channel_importance_batched(meta, meta)
        with pytest.raises(ValueError, match="no kernel for device"):
            mm_ops.masked_merge(meta[0], meta, m.to("meta"))
    else:
        with pytest.raises(ValueError, match="channel-shaped"):
            agg_ops.masked_weighted_sum(x, torch.ones(2, 4, 3), w)


@pytest.mark.parametrize("n,leaf", [(10, (64, 16)), (5, (3, 3, 4, 8)),
                                    (6, (33,))])
@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
@pytest.mark.parametrize("dense", [False, True], ids=["channel", "ones"])
@pytest.mark.parametrize("with_prev", [False, True])
def test_sparse_agg_mean_mode_matches_finish_masked_mean(n, leaf, dt, dense,
                                                         with_prev):
    """The mean mode (``masked_weighted_mean``) against the JAX package's
    ``finish_masked_mean(*leaf_masked_partials(...))``, jnp and Pallas
    (interpret mode).  Channel 0 is uploaded by no client, so with a
    previous global it is filled from it, exactly.  fp32 within 1e-5
    relative (the two packages sum the clients in other orders); bf16
    within one bf16 ulp (2**-7 relative), since an fp32 quotient an ulp
    away can round to the neighbouring bf16 value."""
    _, jdt, tdt = dt
    rng = np.random.default_rng(n * 31 + len(leaf))
    sw = rng.normal(size=(n,) + leaf).astype(np.float32)
    if dense:
        mask = np.ones((n,) + (1,) * len(leaf), np.float32)
    else:
        mask = (rng.uniform(size=(n,) + (1,) * (len(leaf) - 1) + leaf[-1:])
                > 0.5).astype(np.float32)
        mask[..., 0] = 0.0
    wts = rng.integers(10, 100, n).astype(np.float32)
    wts[1] = 0.0
    gprev = rng.normal(size=leaf).astype(np.float32)
    got = agg_ops.masked_weighted_mean(
        as_torch(sw, tdt), as_torch(mask, tdt), torch.from_numpy(wts),
        as_torch(gprev, tdt) if with_prev else None, tdt)
    assert got.dtype == tdt and tuple(got.shape) == leaf
    jw = as_jax(sw, jdt)
    jm = np.broadcast_to(np.asarray(as_jax(mask, jdt)), jw.shape)
    rtol, atol = (1e-5, 1e-6) if tdt == torch.float32 else (2.0 ** -7, 1e-6)
    for use_kernel in (False, True):
        num, den = jax_agg.leaf_masked_partials(jw, jm, as_jax(wts),
                                                use_kernel=use_kernel)
        want = jax_agg.finish_masked_mean(
            num, den, as_jax(gprev, jdt) if with_prev else None, jdt)
        np.testing.assert_allclose(np32(got), np32(want), rtol=rtol,
                                   atol=atol)
    if with_prev and not dense:
        np.testing.assert_array_equal(np32(got)[..., 0],
                                      np32(as_jax(gprev, jdt))[..., 0])


def test_sparse_agg_mean_mode_is_finish_over_partials_on_cpu():
    """On the CPU the mean mode is the partials' plain version finished by
    ``aggregation.finish_masked_mean``, bit for bit, in either dtype and
    with a previous global of the other dtype."""
    from repro_torch.core import aggregation
    rng = np.random.default_rng(11)
    sw = rng.normal(size=(7, 40, 24)).astype(np.float32)
    mask = (rng.uniform(size=(7, 1, 24)) > 0.5).astype(np.float32)
    mask[..., 3] = 0.0
    wts = torch.from_numpy(rng.uniform(0.5, 2, 7).astype(np.float32))
    gprev = torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32))
    for tdt in (torch.float32, torch.bfloat16):
        w, m = as_torch(sw, tdt), as_torch(mask, tdt)
        num, den = agg_ops.masked_weighted_sum(w, m, wts)
        for out_dt in (torch.float32, torch.bfloat16):
            for g in (None, gprev, gprev.bfloat16()):
                got = agg_ops.masked_weighted_mean(w, m, wts, g, out_dt)
                want = aggregation.finish_masked_mean(num, den, g, out_dt)
                assert got.dtype == out_dt
                assert torch.equal(got, want)


def test_sparse_agg_mean_mode_rejects_bad_operands():
    x, m, w = torch.ones(2, 4, 3), torch.ones(2, 1, 3), torch.ones(2)
    with pytest.raises(ValueError, match="shaped like the leaf"):
        agg_ops.masked_weighted_mean(x, m, w, torch.ones(3, 4))
    with pytest.raises(TypeError):
        agg_ops.masked_weighted_mean(x, m, w, torch.ones(4, 3).double())
    with pytest.raises(TypeError):
        agg_ops.masked_weighted_mean(x, m, w, None, torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        agg_ops.masked_weighted_mean(x, m, w, torch.ones(3, 4).t())
    with pytest.raises(ValueError, match="different devices"):
        agg_ops.masked_weighted_mean(x, m, w, torch.ones(4, 3).to("meta"))


H100_SMS = 132


@pytest.mark.parametrize("n,leaf,vec", [
    (16, (3, 3, 512, 512), 4), (16, (3, 3, 512, 512), 8),
    (16, (1024, 500), 4), (8, (64, 640), 4), (200, (100, 10), 2)])
def test_importance_work_plan_keeps_a_full_leaf_whole(n, leaf, vec):
    """S = 1 where N * ceil(C / tile) blocks already fill a 132-SM card."""
    a, c, b = int(np.prod(leaf[:-1])), leaf[-1], 1
    plan = imp_ops.work_plan(n, a, c, b, H100_SMS, vec)
    assert n * -(-c // plan.tile) >= H100_SMS
    assert plan.splits == 1 and plan.blocks == n * -(-c // plan.tile)


@pytest.mark.parametrize("n,leaf,vec", [
    (10, (784, 100), 4), (10, (784, 100), 1), (10, (100, 64), 4),
    (10, (64, 10), 2), (10, (100,), 4), (7, (257, 513), 1),
    (5, (1000, 7), 1), (3, (3, 3, 4, 8), 4), (1, (100000, 32), 4)])
def test_importance_work_plan_splits_the_fan_in_of_small_leaves(n, leaf,
                                                                vec):
    """Where the leaf alone leaves SMs idle the fan-in is split across at
    most MAX_SPLITS blocks (one cluster), toward 2-4 blocks per SM, but no
    further than leaves every row slice of a split a full step of UNROLL
    rows; at fc0 (10, 784, 100) S >= 2."""
    a, c = int(np.prod(leaf[:-1])), leaf[-1]
    plan = imp_ops.work_plan(n, a, c, 1, H100_SMS, vec)
    base = n * -(-c // imp_ops.TILE)
    assert base < H100_SMS
    assert 1 <= plan.splits <= imp_ops.MAX_SPLITS
    assert plan.blocks == base * plan.splits <= 4 * H100_SMS
    step = imp_ops.THREADS // (imp_ops.TILE // vec) * imp_ops.UNROLL
    assert plan.splits <= max(1, -(-a // step))
    if a >= imp_ops.MAX_SPLITS * step:     # the rows allow any split
        assert plan.blocks >= min(imp_ops.BLOCKS_PER_SM * H100_SMS,
                                  base * imp_ops.MAX_SPLITS)
    if a <= step:                          # one step of rows: no split
        assert plan.splits == 1
    if (n, leaf) == (10, (784, 100)):
        assert plan.splits >= 2


@pytest.mark.parametrize("rows", [1, 7, 8, 257, 784, 1000])
@pytest.mark.parametrize("splits", range(1, 9))
def test_importance_split_rows_cover_each_row_once(rows, splits):
    got = imp_ops.split_rows(rows, splits)
    assert len(got) == splits
    assert got[0][0] == 0 and got[-1][1] == rows
    covered = [r for lo, hi in got for r in range(lo, hi)]
    assert covered == list(range(rows))


@pytest.mark.parametrize("n,leaf", [(10, (784, 100)), (7, (257, 513)),
                                    (5, (1000, 7))])
def test_importance_split_partials_sum_to_plain(n, leaf):
    """The kernel's arithmetic with the fan-in split as its work plan
    splits it (per split a sum of squares over its rows, the splits summed
    in rank order, then sqrt) agrees with the plain version (rtol 5e-5,
    atol 1e-5)."""
    wo, wn = _pair(np.random.default_rng(n), (n,) + leaf)
    a, c = leaf
    plan = imp_ops.work_plan(n, a, c, 1, H100_SMS, 1)
    wo_t, wn_t = torch.from_numpy(wo), torch.from_numpy(wn)
    total = torch.zeros(n, c)
    for lo, hi in imp_ops.split_rows(a, plan.splits):
        part = imp_ops.channel_importance_batched(
            wo_t[:, lo:hi].contiguous(), wn_t[:, lo:hi].contiguous())
        total += part * part
    want = imp_ops.channel_importance_batched(wo_t, wn_t)
    np.testing.assert_allclose(np32(torch.sqrt(total)), np32(want),
                               rtol=5e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,inner,offset,most,want", [
    (torch.float32, 100, 0, 8, 4), (torch.float32, 10, 0, 8, 2),
    (torch.float32, 7, 0, 8, 1), (torch.bfloat16, 64, 0, 8, 8),
    (torch.bfloat16, 64, 0, 4, 4), (torch.bfloat16, 100, 0, 8, 4),
    (torch.float32, 100, 1, 8, 1), (torch.bfloat16, 64, 2, 8, 2)])
def test_vector_width_divides_the_row_and_keeps_alignment(dtype, inner,
                                                          offset, most,
                                                          want):
    from repro_torch.kernels import _lib
    base = torch.empty(4 * inner + 16, dtype=dtype)
    t = base[offset:offset + 4 * inner]
    assert _lib.vector_width(inner, t, most=most) == want
