"""The port's kernels, held against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels run
as tests/test_kernels.py runs them (``repro.kernels.*.ops``, interpret mode)
and beside them the JAX ``ref.py`` oracles.  Inputs are seeded numpy
arrays, cast to each dtype the same way (round to nearest even) in both
packages.  Tolerances are those of tests/test_kernels.py: importance rtol
5e-5 / atol 1e-5, Eq. (4) num rtol 3e-5 (fp32) or 5e-3 (bf16) with atol
1e-4, den rtol 3e-5 / atol 1e-5, Eq. (5) exact.
"""

import jax.numpy as jnp
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


MLP_TREE = {"fc0": {"b": (100,), "w": (784, 100)},
            "fc1": {"b": (64,), "w": (100, 64)},
            "fc2": {"b": (10,), "w": (64, 10)}}


def _mlp_merge_inputs(n, seed):
    """Seeded numpy (global, stacked local, channel-last mask) pytrees of
    the paper's MLP, the masks shaped as the engine builds them."""
    from repro_torch import tree
    rng = np.random.default_rng(seed)
    g = tree.tree_map(lambda s: rng.normal(size=s).astype(np.float32),
                      MLP_TREE)
    loc = tree.tree_map(
        lambda s: rng.normal(size=(n,) + s).astype(np.float32), MLP_TREE)
    mask = tree.tree_map(
        lambda s: (rng.uniform(size=(n,) + (1,) * (len(s) - 1) + s[-1:])
                   > 0.4).astype(np.float32), MLP_TREE)
    return g, loc, mask


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_masked_merge_group_over_mlp_matches_client_update(dt):
    """The group entry over the MLP pytree (one call, the six leaves in
    JAX order) and the port's ``client_update_sparse`` built on it, against
    the JAX engine's Eq. (5) (``aggregation.client_update_sparse``),
    exactly."""
    import jax
    from repro_torch import tree
    from repro_torch.core import aggregation
    _, jdt, tdt = dt
    g, loc, mask = _mlp_merge_inputs(10, 5)
    tg, tl, tm = (tree.tree_map(lambda x: as_torch(x, tdt), t)
                  for t in (g, loc, mask))
    jg, jl, jm = (jax.tree_util.tree_map(lambda x: as_jax(x, jdt), t)
                  for t in (g, loc, mask))
    want = jax.tree_util.tree_leaves(jax_agg.client_update_sparse(jg, jl, jm))
    many = mm_ops.masked_merge_many(tree.leaves(tg), tree.leaves(tl),
                                    tree.leaves(tm))
    via_tree = tree.leaves(aggregation.client_update_sparse(tg, tl, tm))
    assert len(many) == len(via_tree) == len(want) == 6
    for got_many, got_tree, w in zip(many, via_tree, want):
        assert got_many.dtype == tdt
        np.testing.assert_array_equal(np32(got_many), np32(w))
        np.testing.assert_array_equal(np32(got_tree), np32(w))


# (N, leaf, channel axis, mask kind): channel-first leaves (B > 1), an
# all-ones mask (C_m = 1), sizes 10, 33 and 257 x 513, fractional masks
RAGGED_GROUP = [(3, (257, 513), -1, "binary"), (4, (33,), -1, "binary"),
                (5, (10,), -1, "ones"), (3, (6, 7, 5), 0, "binary"),
                (2, (9, 4), 0, "fraction"), (3, (64, 10), -1, "fraction"),
                (2, (3, 3, 4, 8), -1, "ones")]


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_masked_merge_group_ragged_matches_pallas(dt):
    """One group call over a ragged set of leaves against JAX's Pallas
    kernel in interpret mode (``masked_merge`` per client, as
    test_masked_merge_matches_pallas runs it) and the JAX engine's jnp
    Eq. (5) and the kernel's jnp oracle (``ref.py``, fp32 arithmetic).
    Binary and all-ones masks: all three exactly.  Fractional masks: the
    oracle exactly, the jnp Eq. (5) exactly in fp32 (in bf16 it computes
    in bf16 arithmetic, the kernels in fp32), and the Pallas kernel in
    interpret mode within one fp32 ulp of the larger product and one of
    the result (and one bf16 ulp of the result in bf16), because XLA on the
    CPU contracts its ``g * m + l * (1 - m)`` into a fused multiply-add
    where the port and the oracle round each product.  L holds a NaN and
    an inf at a channel the global replaces: the blend keeps NaN * 0 = NaN,
    as the reference does, and is no select."""
    _, jdt, tdt = dt
    rng = np.random.default_rng(15)
    gs, ls, ms, rows = [], [], [], []
    for n, leaf, ax, kind in RAGGED_GROUP:
        ax = ax % len(leaf)
        c = leaf[ax]
        g = rng.normal(size=leaf).astype(np.float32)
        loc = rng.normal(size=(n,) + leaf).astype(np.float32)
        if kind == "ones":
            row = np.ones((n, c), np.float32)
            mshape = (n,) + (1,) * len(leaf)
            ms.append(np.ones(mshape, np.float32))
        else:
            row = (rng.uniform(size=(n, c)) > 0.5 if kind == "binary"
                   else rng.uniform(size=(n, c))).astype(np.float32)
            ms.append(row.reshape((n,) + tuple(c if i == ax else 1
                                               for i in range(len(leaf)))))
        gs.append(g)
        ls.append(loc)
        rows.append(row)
    # a NaN and an inf in L where the first leaf's first client takes G
    ch = int(np.flatnonzero(rows[0][0] > 0)[0])
    ls[0][0, 3, ch], ls[0][0, 4, ch] = np.nan, np.inf
    got = mm_ops.masked_merge_many([as_torch(x, tdt) for x in gs],
                                   [as_torch(x, tdt) for x in ls],
                                   [as_torch(x, tdt) for x in ms])
    assert np.isnan(np32(got[0])[0, 3:5, ch]).all()
    for (n, leaf, ax, kind), out, g, loc, m, row in zip(
            RAGGED_GROUP, got, gs, ls, ms, rows):
        assert out.dtype == tdt and tuple(out.shape) == (n,) + leaf
        ax = ax % len(leaf)
        jg = as_jax(g, jdt)
        if kind != "fraction" or tdt == torch.float32:
            jnp_eq5 = jax_agg.client_update_sparse(jg, as_jax(loc, jdt),
                                                   as_jax(m, jdt))
            np.testing.assert_array_equal(np32(out), np32(jnp_eq5))
        for k in range(n):
            jl, jrow = as_jax(loc[k], jdt), as_jax(row[k], jdt)
            c = leaf[ax]
            oracle = jax_mm_ref(jnp.moveaxis(jg, ax, 0).reshape(c, -1),
                                jnp.moveaxis(jl, ax, 0).reshape(c, -1),
                                jrow)
            oracle = jnp.moveaxis(oracle.reshape(
                (c,) + tuple(np.delete(leaf, ax))), 0, ax)
            np.testing.assert_array_equal(np32(out[k]), np32(oracle))
            want = jax_mm_ops.masked_merge(jg, jl, jrow, channel_axis=ax)
            if kind == "fraction":
                # the fused product skips one rounding: one fp32 ulp of
                # the larger term and one of the result (the sum then rounds
                # the other way), plus one bf16 ulp of the result in bf16
                mk = np.moveaxis(np32(jrow).reshape(
                    (c,) + (1,) * (len(leaf) - 1)), 0, ax)
                terms = np.maximum(np.abs(np32(jg) * mk),
                                   np.abs(np32(jl) * (1 - mk)))
                tol = 2.0 ** -23 * (terms + np.abs(np32(want)))
                if tdt == torch.bfloat16:
                    tol = tol + 2.0 ** -7 * np.abs(np32(want))
                assert np.all(np.abs(np32(out[k]) - np32(want)) <= tol)
            else:
                np.testing.assert_array_equal(np32(out[k]), np32(want))


ALIGNED = (1 << 20, 2 << 20, 3 << 20)     # addresses of G, L, out


def _spec(leaf, n=10, dtype=torch.float32, axis=-1, ones=False,
          addrs=ALIGNED, mask_addr=4 << 20):
    from repro_torch.kernels import _lib
    mshape = (tuple(1 for _ in leaf) if ones else
              tuple(s if i == axis % len(leaf) else 1
                    for i, s in enumerate(leaf)))
    acb, mask_c = _lib.mask_view(leaf, mshape)
    return mm_ops.LeafSpec(dtype, n, acb, mask_c, addrs, mask_addr)


def test_masked_merge_plan_of_the_mlp_is_one_launch():
    """The MLP's six leaves (JAX order) in one launch: vector width 4 where
    C allows it (fc0 fp32: 4), 2 for fc2 (C = 10); N = 10 clients in three
    chunks of at most 4; tiles of THREADS vectors times the chunks, their
    prefix sums in order."""
    from repro_torch import tree
    leaves = tree.leaves(MLP_TREE)
    assert [tuple(s) for s in leaves] == [(100,), (784, 100), (64,),
                                          (100, 64), (10,), (64, 10)]
    (launch,) = mm_ops.plan([_spec(s) for s in leaves])
    assert launch.dtype == torch.float32
    assert [lp.index for lp in launch.leaves] == list(range(6))
    assert [lp.vec for lp in launch.leaves] == [4, 4, 4, 4, 2, 2]
    assert [lp.chunk for lp in launch.leaves] == [4] * 6
    sizes = [int(np.prod(s)) for s in leaves]
    tiles = [-(-(size // lp.vec) // mm_ops.THREADS) * 3
             for size, lp in zip(sizes, launch.leaves)]
    assert [lp.tiles for lp in launch.leaves] == tiles == [3, 462, 3, 39,
                                                           3, 9]
    assert [lp.tile_begin for lp in launch.leaves] == list(
        np.cumsum([0] + tiles[:-1]))
    assert launch.tiles == sum(tiles) == 519


def test_masked_merge_plan_splits_past_max_leaves_and_by_dtype():
    """33 leaves of one dtype give two launches (32 + 1), each with its own
    tile prefix sums; a second dtype takes launches of its own, in the
    order the dtypes first appear; an empty leaf takes none."""
    specs = [_spec((7 + i, 12)) for i in range(33)]
    first, second = mm_ops.plan(specs)
    assert len(first.leaves) == mm_ops.MAX_LEAVES == 32
    assert [lp.index for lp in second.leaves] == [32]
    for launch in (first, second):
        begin = 0
        for lp in launch.leaves:
            assert lp.tile_begin == begin
            begin += lp.tiles
        assert launch.tiles == begin
    mixed = [_spec((64, 10)), _spec((8, 16), dtype=torch.bfloat16),
             _spec((5,), n=0), _spec((3, 3)),
             _spec((4, 4), dtype=torch.bfloat16)]
    f32, b16 = mm_ops.plan(mixed)
    assert (f32.dtype, [lp.index for lp in f32.leaves]) == (torch.float32,
                                                            [0, 3])
    assert (b16.dtype, [lp.index for lp in b16.leaves]) == (torch.bfloat16,
                                                            [1, 4])


@pytest.mark.parametrize("spec,vec,chunk", [
    (_spec((784, 100)), 4, 4),
    (_spec((784, 100), dtype=torch.bfloat16), 4, 4),
    (_spec((10,)), 2, 4),
    (_spec((64, 10)), 2, 4),
    (_spec((8, 7), dtype=torch.bfloat16), 1, 4),
    (_spec((33,)), 1, 4),
    (_spec((784, 100), mask_addr=(4 << 20) + 4), 1, 4),
    (_spec((784, 100), mask_addr=(4 << 20) + 8), 2, 4),
    (_spec((784, 100), addrs=(1 << 20, (2 << 20) + 4, 3 << 20)), 1, 4),
    (_spec((784, 100), ones=True), 4, 4),
    (_spec((784, 100), ones=True, mask_addr=(4 << 20) + 4), 4, 4),
    (_spec((6, 7, 5), axis=0), 1, 4),
    (_spec((9, 4), axis=0, n=18), 4, 4),
    (_spec((9, 4), axis=0, n=6), 4, 3),
    (_spec((3, 3, 512, 512), n=16, dtype=torch.bfloat16), 8, 4),
    (_spec((1024, 500), n=16, dtype=torch.bfloat16), 4, 4),
    (_spec((1024, 500), n=1), 4, 1),
])
def test_masked_merge_leaf_plan_vector_width_and_chunks(spec, vec, chunk):
    """V is the largest width up to 16 bytes that divides C (channel axis
    last) or B (channel axis before others) and keeps G, L, the output and,
    channel last, the mask aligned (an all-ones mask is one value a client
    and never limits it); the clients go in the fewest equal chunks of at
    most CLIENTS."""
    lp = mm_ops.leaf_plan(spec)
    assert (lp.vec, lp.chunk) == (vec, chunk)
    a, c, b = spec.acb
    assert (b if b > 1 else c) % lp.vec == 0
    assert lp.chunk <= mm_ops.CLIENTS
    chunks = -(-spec.n // lp.chunk)
    assert lp.tiles == -(-(a * c * b // lp.vec) // mm_ops.THREADS) * chunks


def test_masked_merge_plan_rejects_a_leaf_of_2_31_elements():
    """32-bit indices: one descriptor (``leaf_plan``) refuses 2**31
    elements or more (2**31 - 1 is taken); ``plan`` cuts such a leaf into
    several descriptors, each under the limit."""
    with pytest.raises(ValueError, match="fewer than"):
        mm_ops.leaf_plan(_spec((1 << 16, 1 << 15)))
    with pytest.raises(ValueError, match="fewer than"):
        mm_ops.leaf_plan(_spec((1 << 31,), n=1))
    (launch,) = mm_ops.plan([_spec(((1 << 31) - 1,), n=1)])
    assert launch.leaves[0].vec == 1
    for specs in ([_spec((1 << 16, 1 << 15))],
                  [_spec((8,)), _spec((1 << 31,), n=1)]):
        for launch in mm_ops.plan(specs):
            for lp in launch.leaves:
                a, c, b = lp.spec.acb
                assert a * c * b < mm_ops.MAX_ELEMENTS


@pytest.mark.parametrize("acb", [(32769, 65536, 1), (1, 3 << 30, 1),
                                 (2, 3, (1 << 31) + 5), (5, 1 << 20, 1 << 11),
                                 (7, 9, 11)])
def test_masked_merge_split_leaf_covers_every_element_once(acb):
    """The pieces of a client leaf tile it in order, each under 2**31
    elements, and each starts on a channel boundary: a run of whole rows,
    of whole channels of one row, or of one channel."""
    a, c, b = acb
    pieces = mm_ops.split_leaf(acb)
    end = 0
    for p in pieces:
        pa, pc, pb = p.acb
        assert p.offset == end
        assert 0 < pa * pc * pb < mm_ops.MAX_ELEMENTS
        assert (p.offset // b) % c == p.c0 and p.c0 + pc <= c
        if pa > 1:
            assert (pc, pb, p.c0) == (c, b, 0) and p.offset % (c * b) == 0
        elif pb == b:
            assert p.offset % b == 0
        end += pa * pc * pb
    assert end == a * c * b
    if a * c * b < mm_ops.MAX_ELEMENTS:
        assert pieces == [mm_ops.Piece(0, acb, 0)]


def _emulate_merge(launches, g, loc, m, es):
    """The kernel's arithmetic over the launch plan, in numpy: for every
    descriptor, client and element, the channel (e // B) % C of the
    descriptor and the mask at its address plus that (addresses in bytes
    from 0 for G, 1 << 40 for L and the output, 1 << 50 for the mask)."""
    out = np.full(loc.size, np.nan, np.float32)
    gf, lf, mf = g.reshape(-1), loc.reshape(-1), m.reshape(-1)
    for launch in launches:
        for lp in launch.leaves:
            s = lp.spec
            a, c, b = s.acb
            g0 = s.addrs[0] // es
            l0 = (s.addrs[1] - (1 << 40)) // es
            m0 = (s.mask_addr - (1 << 50)) // es
            stride = a * c * b       # one client a descriptor when split
            e = np.arange(a * c * b)
            ch = (e // b) % c if s.mask_c != 1 else 0 * e
            for k in range(s.n):
                mk = mf[m0 + k * s.mask_c + ch]
                idx = k * stride + l0 + e
                out[idx] = gf[g0 + e] * mk + lf[idx] * (1 - mk)
    return out.reshape(loc.shape)


@pytest.mark.parametrize("leaf,axis,ones", [
    ((37, 12), -1, False), ((3, 50), -1, False), ((4, 7, 9), 1, False),
    ((2, 3, 40), 0, False), ((19, 12), -1, True)])
def test_masked_merge_plan_of_a_split_leaf_merges_like_plain(
        leaf, axis, ones, monkeypatch):
    """With the descriptor limit lowered to 64 elements, the plan of a
    leaf cut into pieces (runs of rows, of channels, of one channel; one
    descriptor per client and piece), carried out as the kernel reads its
    table, equals torch.where over the whole leaf: every element of every
    client once, with its own channel's mask."""
    from repro_torch.kernels import _lib
    monkeypatch.setattr(mm_ops, "MAX_ELEMENTS", 64)
    n = 3
    rng = np.random.default_rng(len(leaf) + leaf[0])
    g = rng.normal(size=leaf).astype(np.float32)
    loc = rng.normal(size=(n,) + leaf).astype(np.float32)
    mshape = (tuple(1 for _ in leaf) if ones else
              tuple(s if i == axis % len(leaf) else 1
                    for i, s in enumerate(leaf)))
    m = (rng.uniform(size=(n,) + mshape) > 0.5).astype(np.float32)
    acb, mask_c = _lib.mask_view(leaf, mshape)
    spec = mm_ops.LeafSpec(torch.float32, n, acb, mask_c,
                           (0, 1 << 40, 1 << 40), 1 << 50)
    launches = mm_ops.plan([spec])
    assert sum(len(l.leaves) for l in launches) > 1
    got = _emulate_merge(launches, g, loc, m, 4)
    want = np.where(np.broadcast_to(m, loc.shape) > 0, g[None], loc)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 10, 64, 100, 257, 513, 4097,
                               (1 << 20) + 1, (1 << 30) + 3, (1 << 31) - 1])
def test_masked_merge_divmod_constants_divide_every_31_bit_index(d):
    """The kernel's channel divmod: (x * mul) >> (32 + shr) == x // d for
    x < 2**31, at the edges and at seeded random x."""
    mul, shr = mm_ops.divmod_constants(d)
    assert 0 <= mul < 1 << 32 and 0 <= shr <= 31
    rng = np.random.default_rng(d % 1000)
    xs = [0, 1, d - 1, d, d + 1, 2 * d - 1, (1 << 31) - 1, (1 << 31) - 2]
    xs += [int(x) for x in rng.integers(0, 1 << 31, 200)]
    for x in xs:
        if 0 <= x < 1 << 31:
            assert (x if d == 1 else (x * mul) >> 32 >> shr) == x // d


@pytest.mark.parametrize("case", ["tree", "dtype", "contiguity", "device",
                                  "devices"])
def test_masked_merge_group_rejects_what_the_kernel_does_not_take(case):
    """The group entry checks every leaf as the single-leaf entry does, and
    that the group lies on one device."""
    from repro_torch.core import aggregation
    x, m = torch.ones(2, 4, 3), torch.ones(2, 1, 3)
    good = ([x[0], x[0, 0]], [x, x[:, 0].contiguous()], [m, m[:, 0]])
    assert len(mm_ops.masked_merge_many(*good)) == 2
    g, l, ms = (list(t) for t in good)
    if case == "tree":
        with pytest.raises(ValueError, match="masks"):
            mm_ops.masked_merge_many(g, l, ms[:1])
        with pytest.raises(ValueError, match="do not fit"):
            mm_ops.masked_merge_many([g[1], g[0]], l, ms)
        with pytest.raises(ValueError, match="structure"):
            aggregation.client_update_sparse({"w": g[0]}, {"v": l[0]},
                                             {"w": ms[0]})
    elif case == "dtype":
        with pytest.raises(TypeError):
            mm_ops.masked_merge_many(g, l, [ms[0], ms[1].bfloat16()])
        with pytest.raises(TypeError):
            mm_ops.masked_merge_many([g[0], g[1].double()],
                                     [l[0], l[1].double()],
                                     [ms[0], ms[1].double()])
    elif case == "contiguity":
        bad = torch.ones(2, 3, 4).transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            mm_ops.masked_merge_many(g, [l[0], bad[:, 0]], ms)
        with pytest.raises(ValueError, match="contiguous"):
            mm_ops.masked_merge_many([g[0], bad[0, 0]], l, ms)
    elif case == "device":
        with pytest.raises(ValueError, match="no kernel for device"):
            mm_ops.masked_merge_many(
                *([t.to("meta") for t in ts] for ts in (g, l, ms)))
    else:
        with pytest.raises(ValueError, match="different devices"):
            mm_ops.masked_merge_many(g, [l[0], l[1].to("meta")], ms)


def test_masked_merge_group_on_cpu_counts_no_launch():
    """CPU tensors take the plain version leaf by leaf: no launch and no
    leaf count moves."""
    before, leaves = launch_counts(), mm_ops.leaf_counts()
    x = torch.ones(2, 4, 3)
    mm_ops.masked_merge_many([x[0], x[0]], [x, x], [torch.ones(2, 1, 3)] * 2)
    assert launch_counts() == before and mm_ops.leaf_counts() == leaves


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
        # sparse_agg takes a channel-shaped, all-ones or elementwise mask
        # (shaped like the values); masked_merge a channel-shaped one only
        with pytest.raises(ValueError, match="channel-shaped"):
            agg_ops.masked_weighted_sum(x, torch.ones(2, 2, 3), w)
        with pytest.raises(ValueError, match="channel-shaped"):
            mm_ops.masked_merge(x[0], x, torch.ones(2, 4, 3))


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


# ------------------------------------------- launches follow their tensors

class _FakeCuda:
    """Stand-ins for ``torch.cuda``'s current device, stream and device
    guard: records which device each was asked for."""

    def __init__(self, current=0):
        self.current = current
        self.guards = []
        self.streams = []

    def current_device(self):
        return self.current

    def current_stream(self, device=None):
        import types
        index = torch.device(device).index
        self.streams.append(index)
        return types.SimpleNamespace(cuda_stream=1000 + index)

    def device(self, device):
        import contextlib
        fake = self

        @contextlib.contextmanager
        def guard():
            fake.guards.append(torch.device(device).index)
            saved, fake.current = fake.current, torch.device(device).index
            try:
                yield
            finally:
                fake.current = saved
        return guard()


@pytest.mark.parametrize("index,current", [(1, 0), (0, 0), (3, 1)])
def test_launch_runs_on_its_tensors_device_and_stream(index, current,
                                                      monkeypatch):
    """``_lib.launch`` hands the kernel the current stream of the tensors'
    card, with that card current: under a device guard only when another
    card is current (no guard on the common path)."""
    import collections
    import types
    from repro_torch.kernels import _lib
    fake = _FakeCuda(current)
    seen = []

    def symbol(*args):
        seen.append((args, fake.current))
        return 0

    monkeypatch.setattr(_lib, "load",
                        lambda: types.SimpleNamespace(feddd_x=symbol))
    for name in ("current_device", "current_stream", "device"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    monkeypatch.setattr(_lib, "_launches", collections.Counter())
    monkeypatch.setattr(_lib, "_routes", collections.Counter())
    _lib.launch("masked_merge", "feddd_x", 7, 8,
                device=torch.device("cuda", index), route=1)
    assert seen == [((7, 8, 1000 + index), index)]
    assert fake.streams == [index]
    assert fake.guards == ([] if index == current else [index])
    assert fake.current == current
    assert _lib.launch_counts()["masked_merge"] == 1


def test_sm_count_reads_the_tensors_own_card(monkeypatch):
    import types
    asked = []

    def props(device):
        asked.append(torch.device(device))
        return types.SimpleNamespace(multi_processor_count=100 + asked[-1]
                                     .index)

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    imp_ops.sm_count.cache_clear()
    try:
        assert imp_ops.sm_count(torch.device("cuda", 2)) == 102
        assert imp_ops.sm_count(torch.device("cuda", 0)) == 100
    finally:
        imp_ops.sm_count.cache_clear()
    assert asked == [torch.device("cuda", 2), torch.device("cuda", 0)]


@pytest.mark.parametrize("which", ["importance", "sparse_agg",
                                   "sparse_agg_mean", "masked_merge",
                                   "flash_attention"])
def test_every_wrapper_launches_on_its_tensors_device(which, monkeypatch):
    """Each wrapper passes its tensors' device to ``_lib.launch`` (here
    made to take the kernel path for CPU tensors, with the launch
    recorded and not made)."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import ops as flash_ops
    got = []
    monkeypatch.setattr(_lib, "kernel_device", lambda *t: "cuda")
    monkeypatch.setattr(_lib, "launch",
                        lambda *a, device, route=None: got.append(device))
    monkeypatch.setattr(imp_ops, "sm_count", lambda device: 132)
    x = torch.ones(3, 8, 16)
    m = torch.ones(3, 1, 16)
    w = torch.ones(3)
    if which == "importance":
        imp_ops.channel_importance_batched(x, x)
    elif which == "sparse_agg":
        agg_ops.masked_weighted_sum(x, m, w)
    elif which == "sparse_agg_mean":
        agg_ops.masked_weighted_mean(x, m, w, x[0], torch.float32)
    elif which == "masked_merge":
        mm_ops.masked_merge(x[0], x, m)
    else:
        q = torch.ones(1, 16, 2, 64, dtype=torch.bfloat16)
        flash_ops.flash_attention(q, q, q)
    assert got == [x.device]
