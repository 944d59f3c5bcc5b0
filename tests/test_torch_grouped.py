"""The shape-grouped round engine for ragged (model-heterogeneous) fleets,
held against the JAX package and against the port's own per-client loop.

Fixtures: the JAX package's ragged fleet of ``tests/test_grouped_engine.py``
(widths 12, 8, 6 cycling over the clients, a 20-w-5 MLP), and a narrow VGG
(``_vgg([8, 16, 16, 32, 32], [20, 20])``) with narrower sub-models, whose
conv leaves pad their input channels too.  Every input is made from a seed
with numpy and crosses to both packages; pseudo-training perturbs each
leaf with numpy noise seeded by the client's training key (the two
packages' keys are equal bit for bit), so both packages train alike.

* the port's grouped run equals the port's loop (``batched=False``) bit
  for bit: globals, client params, every RoundRecord field but the host
  wall time, and sim_time;
* the grouped run is within tolerance of the JAX package's loop for
  feddd, fedavg, fedcs and oort, with equal participants and sim_time;
* the grouped step, ``build_masks_batched(coverage=, client_indices=)``,
  ``quantize_dequantize_stacked(client_indices=)``,
  ``aggregate_sparse_grouped`` and ``sparse_agg``'s elementwise-mask mode
  against the JAX package (importance rtol 5e-5 / atol 1e-5, Eq. (4)
  3e-5 in fp32 and 5e-3 in bf16, Eq. (5) exact, masks equal but at
  near-ties of the k-th score);
* routing, and ``python -m repro_torch.heterogeneous`` at a reduced size.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.payload import CommConfig as JaxComm
from repro.core import aggregation as jax_agg
from repro.core import coverage as jax_cov
from repro.core import protocol as jax_protocol
from repro.core import round_engine as jax_re
from repro.core import selection as jax_sel
from repro.core.allocation import ClientTelemetry as JaxTelemetry
from repro.comm import quantize as jax_quant
from repro.fl import heterogeneity as jax_het
from repro.fl import models as jax_models
from repro.kernels.sparse_agg import ops as jax_agg_ops
from repro.kernels.sparse_agg.sparse_agg import masked_weighted_sum_2d
from repro_torch import convert, tree
from repro_torch.comm import CommConfig, quantize
from repro_torch.core import aggregation, coverage, protocol, round_engine
from repro_torch.core import importance, selection
from repro_torch.core.allocation import ClientTelemetry
from repro_torch.fl import heterogeneity, models
from repro_torch.kernels.sparse_agg import ops as agg_ops

from torch_parity import (DTYPES, as_jax, as_torch, assert_masks_match,
                          jax_tree, np32)

WIDTHS = (12, 8, 6)          # ragged 3-width fleet, cycling over clients
VGG_FULL = ([8, 16, 16, 32, 32], [20, 20])
VGG_SUBS = [VGG_FULL, ([8, 16, 8, 32, 16], [20, 20]),
            ([4, 16, 16, 16, 32], [10, 20])]
RECORD_SKIP = ("host_wall_time",)


@pytest.fixture
def one_thread():
    """Bit-for-bit runs: one intra-op thread, one blocking of each sum."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mlp(rng, w):
    return {"fc0": {"w": rng.normal(size=(20, w)).astype(np.float32),
                    "b": rng.normal(size=w).astype(np.float32) * 0.1},
            "fc1": {"w": rng.normal(size=(w, 5)).astype(np.float32),
                    "b": np.zeros(5, np.float32)}}


def _mlp_fleet(n=6, seed=0, widths=WIDTHS):
    rng = np.random.default_rng(seed)
    gp = _mlp(rng, max(widths))
    return gp, [_mlp(rng, widths[i % len(widths)]) for i in range(n)]


def _vgg_params(rng, widths, fcs):
    """numpy params of ``_vgg(widths, fcs)``, the layout of both packages."""
    out, li = {}, 0
    for layer in models._vgg(widths, fcs):
        if layer[0] == "conv":
            _, cin, cout, k = layer
            out[f"conv{li}"] = {
                "w": (rng.normal(size=(k, k, cin, cout))
                      / np.sqrt(cin * k * k)).astype(np.float32),
                "b": (0.1 * rng.normal(size=cout)).astype(np.float32)}
            li += 1
        elif layer[0] == "fc":
            _, din, dout = layer
            out[f"fc{li}"] = {
                "w": (rng.normal(size=(din, dout))
                      / np.sqrt(din)).astype(np.float32),
                "b": (0.1 * rng.normal(size=dout)).astype(np.float32)}
            li += 1
    return out


def _vgg_fleet(n=5, seed=0):
    rng = np.random.default_rng(seed)
    gp = _vgg_params(rng, *VGG_FULL)
    return gp, [_vgg_params(rng, *VGG_SUBS[i % len(VGG_SUBS)])
                for i in range(n)]


def _nbytes(p):
    return float(sum(l.size * 4 for l in jax.tree_util.tree_leaves(p)))


def _tel_kw(clients, seed=0):
    n = len(clients)
    rng = np.random.default_rng(seed)
    return dict(model_bytes=np.asarray([_nbytes(p) for p in clients]),
                uplink_rate=rng.uniform(1e3, 5e3, n),
                downlink_rate=rng.uniform(5e3, 2e4, n),
                compute_latency=rng.uniform(1.0, 5.0, n),
                num_samples=rng.integers(10, 50, n).astype(float),
                label_coverage=rng.uniform(0.5, 1.0, n),
                train_loss=np.ones(n))


def _noise(key, shapes):
    """Seeded by the training key's two words (equal in both packages)."""
    rng = np.random.default_rng(np.asarray(key, np.uint32).tolist())
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _ltf_torch(p, idx, key):
    leaves, td = tree.flatten(p)
    noise = _noise(key, [tuple(l.shape) for l in leaves])
    return (tree.unflatten(td, [l * 0.99 + 0.01 * torch.from_numpy(z)
                                for l, z in zip(leaves, noise)]),
            1.0 / (idx + 1.0))


def _ltf_jax(p, idx, key):
    leaves, td = jax.tree_util.tree_flatten(p)
    noise = _noise(key, [tuple(l.shape) for l in leaves])
    return (jax.tree_util.tree_unflatten(
        td, [l * 0.99 + 0.01 * jnp.asarray(z) for l, z in zip(leaves, noise)]),
        1.0 / (idx + 1.0))


def _port_server(gp, clients, tel_kw, **kw):
    return protocol.FedDDServer(gp, protocol.ProtocolConfig(**kw),
                                ClientTelemetry(**tel_kw),
                                client_params=clients, device="cpu")


def _jax_run(gp, clients, tel_kw, **kw):
    srv = jax_protocol.FedDDServer(
        jax_tree(gp), jax_protocol.ProtocolConfig(**kw),
        JaxTelemetry(**tel_kw), client_params=[jax_tree(c)
                                               for c in clients])
    return srv, srv.run(_ltf_jax)


def _trees_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _record(rec):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in vars(rec).items() if k not in RECORD_SKIP}


# --- shape groups --------------------------------------------------------

FLEETS = {
    "ragged": lambda: _mlp_fleet(7)[1],             # widths 12,8,6,12,...
    "homogeneous": lambda: [_mlp_fleet(1)[1][0]] * 4,
    "noncontiguous": lambda: [_mlp(np.random.default_rng(i), w)
                              for i, w in enumerate((6, 12, 6, 8, 12, 12))],
    "vgg": lambda: _vgg_fleet(6)[1],
}


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_group_by_shape_matches_jax(fleet):
    """Partitions, their order and the (shape, dtype) part of each
    signature equal the JAX package's; the port's treedef is hashable and
    equal for equal structures (the signature keys a dict)."""
    clients = FLEETS[fleet]()
    got = heterogeneity.group_by_shape(
        [convert.to_torch(c, "cpu") for c in clients])
    want = jax_het.group_by_shape([jax_tree(c) for c in clients])
    assert [g.indices for g in got] == [g.indices for g in want]
    assert [g.size for g in got] == [g.size for g in want]
    for g, w in zip(got, want):
        assert g.signature[1] == w.signature[1]
        hash(g.signature)
    a, b = (heterogeneity.shape_signature(convert.to_torch(c, "cpu"))
            for c in (clients[0], clients[0]))
    assert a == b and hash(a) == hash(b)
    if fleet == "homogeneous":
        assert len(got) == 1


def test_vgg_specs_and_inits_match_jax():
    assert models.HETERO_A_SPECS == jax_models.HETERO_A_SPECS
    assert models.HETERO_B_SPECS == jax_models.HETERO_B_SPECS
    assert models._vgg(*VGG_FULL) == jax_models._vgg(*VGG_FULL)
    full = models.init_cnn_spec(models.HETERO_A_SPECS[0], device="cpu")
    assert sum(l.numel() for l in tree.leaves(full)) == 3_973_194
    for got, want in ((models.init_mlp(device="cpu"),
                       jax_models.init_mlp(jax.random.PRNGKey(0))),
                      (models.init_cnn("cnn1", device="cpu"),
                       jax_models.init_cnn(jax.random.PRNGKey(0), "cnn1"))):
        for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(np32(g), np32(w), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("name", ["partition_noniid_a",
                                  "partition_dirichlet",
                                  "partition_class_imbalanced"])
def test_partitions_match_jax(name):
    """The numpy copies of the JAX package's partitioners give the same
    index arrays for the same dataset and seed."""
    from repro.data import partition as jax_part
    from repro.data import synthetic as jax_synth
    from repro_torch.data import partition, synthetic
    got = getattr(partition, name)(
        synthetic.make_dataset("cifar10", num_train=700, num_test=10)[0], 7,
        seed=3)
    want = getattr(jax_part, name)(
        jax_synth.make_dataset("cifar10", num_train=700, num_test=10)[0], 7,
        seed=3)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --- masks, quantization ---------------------------------------------------

def _stacked_pair(rng, n, widths=(8,), scale=0.05):
    olds = [_mlp(rng, widths[i % len(widths)]) for i in range(n)]
    news = [jax.tree_util.tree_map(
        lambda x: (x + scale * rng.normal(size=x.shape)).astype(np.float32),
        p) for p in olds]
    return olds, news


def _stack_np(trees):
    return jax.tree_util.tree_map(lambda *ls: np.stack(ls), *trees)


@pytest.mark.parametrize("scheme", ["feddd", "random"])
def test_build_masks_batched_coverage_matches_jax(scheme):
    """Coverage-divided scores over a group with non-contiguous fleet ids:
    equal to the JAX package's batched builder (feddd: but at near-ties;
    random: bit for bit) and to the port's per-client ``build_masks``
    looped over the members (bit for bit)."""
    rng = np.random.default_rng(9)
    n = 4
    olds, news = _stacked_pair(rng, n)
    cov = jax.tree_util.tree_map(
        lambda l: np.linspace(0.2, 1.0, l.shape[-1]).astype(np.float32),
        olds[0])
    drop = np.linspace(0.1, 0.7, n)
    ids = np.asarray([3, 7, 11, 12])
    rk = np.asarray(jax.random.PRNGKey(2))
    cfg = selection.SelectionConfig(scheme=scheme)
    so, sn = _stack_np(olds), _stack_np(news)
    got, dens = selection.build_masks_batched(
        convert.to_torch(so, "cpu"), convert.to_torch(sn, "cpu"), drop,
        config=cfg, rng=rk, coverage=convert.to_torch(cov, "cpu"),
        client_indices=ids)
    want, wdens = jax_sel.build_masks_batched(
        jax_tree(so), jax_tree(sn), jnp.asarray(drop, jnp.float32),
        config=jax_sel.SelectionConfig(scheme=scheme), rng=jnp.asarray(rk),
        coverage=jax_tree(cov), client_indices=jnp.asarray(ids))
    np.testing.assert_allclose(np32(dens), np32(wdens), rtol=2e-7)
    for li, (g, w) in enumerate(zip(tree.leaves(got),
                                    jax.tree_util.tree_leaves(want))):
        if scheme == "random":
            np.testing.assert_array_equal(np32(g), np32(w))
            continue
        wo = np.asarray(jax.tree_util.tree_leaves(so)[li])
        wn = np.asarray(jax.tree_util.tree_leaves(sn)[li])
        cv = np.asarray(jax.tree_util.tree_leaves(cov)[li])
        scores = np32(importance.channel_importance_batched(
            torch.from_numpy(wo), torch.from_numpy(wn),
            coverage=torch.from_numpy(cv)))
        keep = np32(selection.keep_count(wn.shape[-1],
                                         torch.as_tensor(drop)))
        assert_masks_match(np32(g).reshape(n, -1), np32(w).reshape(n, -1),
                           scores, keep)
    for pos, i in enumerate(ids):
        one = selection.build_masks(
            convert.to_torch(olds[pos], "cpu"),
            convert.to_torch(news[pos], "cpu"), drop[pos], config=cfg,
            coverage=convert.to_torch(cov, "cpu"),
            rng=jax_rng_fold(rk, 10_000 + int(i)))
        for g, o in zip(tree.leaves(got), tree.leaves(one)):
            assert torch.equal(g[pos], o)


def jax_rng_fold(key, data):
    return np.asarray(jax.random.fold_in(jnp.asarray(key), data))


def test_build_masks_batched_match_loop_density_is_the_loops():
    """``match_loop`` divides kept by total as ``mask_density`` does (the
    grouped engine's densities equal the loop's bit for bit); the default
    multiplies by the reciprocal (the JAX jitted engine), within one
    float32 ulp; the masks are the same either way."""
    rng = np.random.default_rng(4)
    olds, news = _stacked_pair(rng, 5)
    so = convert.to_torch(_stack_np(olds), "cpu")
    sn = convert.to_torch(_stack_np(news), "cpu")
    drop = np.asarray([0.0, 0.13, 0.37, 0.5, 0.71])
    masks, exact = selection.build_masks_batched(so, sn, drop,
                                                 match_loop=True)
    masks_r, recip = selection.build_masks_batched(so, sn, drop)
    assert _trees_equal(masks, masks_r)
    for i in range(5):
        m_i = tree.tree_map(lambda m: m[i], masks)
        n_i = tree.tree_map(lambda l: l[i], sn)
        assert exact[i] == selection.mask_density(n_i, m_i)
    np.testing.assert_allclose(exact.numpy(), recip.numpy(), rtol=1.2e-7)


@pytest.mark.parametrize("qbits", [8, 16])
def test_quantize_stacked_client_indices_matches_jax(qbits):
    rng = np.random.default_rng(qbits)
    _, news = _stacked_pair(rng, 3)
    sn = _stack_np(news)
    ids = np.asarray([4, 1, 9])
    rk = np.asarray(jax.random.PRNGKey(7))
    got = quantize.quantize_dequantize_stacked(
        convert.to_torch(sn, "cpu"), rk, qbits, client_indices=ids)
    want = jax_quant.quantize_dequantize_stacked(
        jax_tree(sn), jnp.asarray(rk), qbits,
        client_indices=jnp.asarray(ids))
    for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np32(g), np32(w))
    # row k equals the per-client QDQ under client ids[k]'s key
    if qbits == 8:
        for pos, i in enumerate(ids):
            one = quantize.quantize_dequantize(
                convert.to_torch(news[pos], "cpu"),
                quantize.client_quant_key(rk, int(i)), qbits)
            for g, o in zip(tree.leaves(got), tree.leaves(one)):
                assert torch.equal(g[pos], o)


# --- Eq. (4) with an elementwise mask ------------------------------------

EW_SHAPES = [(5, (3, 3, 6, 8)), (4, (20, 12)), (3, (7, 33)),
             (6, (2, 3, 4, 5))]


def _ragged_mask(rng, n, leaf):
    """Each client's upload is a leading box of the leaf (its own widths,
    the rest zero-padded) under a random channel mask: elementwise."""
    m = np.zeros((n,) + leaf, np.float32)
    for i in range(n):
        box = tuple(slice(0, max(1, s - (i % 3))) for s in leaf)
        chan = (rng.uniform(size=leaf[-1]) > 0.3).astype(np.float32)
        m[(i,) + box] = np.broadcast_to(chan, leaf)[box]
    m[..., 0] = 0.0                    # a channel no client uploads
    return m


@pytest.mark.parametrize("n,leaf", EW_SHAPES)
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("mode", ["partials", "mean"])
def test_sparse_agg_elementwise_matches_pallas(n, leaf, dt, mode):
    """The elementwise-mask mode on the CPU route against the JAX
    package's Pallas kernel (interpret mode) and its ``_leaf_masked_mean``;
    launches count under the elementwise route."""
    _, jdt, tdt = dt
    rng = np.random.default_rng(n * 100 + len(leaf))
    sw = rng.normal(size=(n,) + leaf).astype(np.float32)
    sm = _ragged_mask(rng, n, leaf)
    wts = (rng.uniform(size=n) + 0.5).astype(np.float32)
    gprev = rng.normal(size=leaf).astype(np.float32)
    w_t, m_t = as_torch(sw, tdt), as_torch(sm, tdt)
    jw, jm = as_jax(sw, jdt), as_jax(sm, jdt)
    num_rtol = 5e-3 if tdt == torch.bfloat16 else 3e-5
    if mode == "partials":
        num, den = agg_ops.masked_weighted_sum(w_t, m_t,
                                               torch.from_numpy(wts))
        c = leaf[0]
        pallas = masked_weighted_sum_2d(
            jw.reshape(n, c, -1), jm.reshape(n, c, -1), as_jax(wts),
            interpret=True)
        for wnum, wden in (pallas, jax_agg_ops.masked_weighted_sum(
                jw, jm, as_jax(wts))):
            np.testing.assert_allclose(np32(num), np32(wnum).reshape(leaf),
                                       rtol=num_rtol, atol=1e-4)
            np.testing.assert_allclose(np32(den), np32(wden).reshape(leaf),
                                       rtol=3e-5, atol=1e-5)
        return
    got = agg_ops.masked_weighted_mean(w_t, m_t, torch.from_numpy(wts),
                                       as_torch(gprev, tdt), tdt)
    rtol = 1e-5 if tdt == torch.float32 else 2.0 ** -7
    for use_kernel in (False, True):
        want = jax_agg._leaf_masked_mean(jw, jm, as_jax(wts),
                                         as_jax(gprev, jdt), use_kernel)
        np.testing.assert_allclose(np32(got), np32(want), rtol=rtol,
                                   atol=1e-6)
    # no client uploaded channel 0: the previous global, exactly
    np.testing.assert_array_equal(np32(got)[..., 0],
                                  np32(as_torch(gprev, tdt))[..., 0])


def test_sparse_agg_elementwise_route_and_broadcast_channel_mask(
        monkeypatch):
    """A channel mask broadcast to the values gives the channel route's
    result bit for bit; on the kernel path (the launch recorded, not made)
    an elementwise mask takes the ":elementwise" route with mask_c equal
    to the leaf size, a channel mask and a 1-D leaf's own-shape mask the
    channel route, and ``mode_counts`` sums both."""
    from repro_torch.kernels import _lib
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 6, 10)).astype(np.float32))
    chan = torch.from_numpy((rng.uniform(size=(4, 1, 10)) > 0.5)
                            .astype(np.float32))
    w = torch.rand(4) + 0.5
    a = agg_ops.masked_weighted_mean(x, chan, w)
    b = agg_ops.masked_weighted_mean(x, chan.expand(x.shape).contiguous(), w)
    assert torch.equal(a, b)
    calls = []
    monkeypatch.setattr(_lib, "kernel_device", lambda *t: "cuda")
    monkeypatch.setattr(_lib, "launch", lambda *args, device, route=None:
                        calls.append((args[12], route)))
    agg_ops.masked_weighted_mean(x, chan.expand(x.shape).contiguous(), w)
    agg_ops.masked_weighted_sum(x, chan.expand(x.shape).contiguous(), w)
    agg_ops.masked_weighted_mean(x, chan, w)
    agg_ops.masked_weighted_mean(x[:, 0].contiguous(), chan[:, 0], w)
    assert calls == [(60, "mean:elementwise"), (60, "partials:elementwise"),
                     (10, "mean"), (10, "mean")]


# --- the grouped canvas ----------------------------------------------------

def _groups_np(clients, news, drop, rk, cov_by_name):
    """Per group: (indices, stacked old, stacked new, coverage, dropout)
    as numpy, the masks built by the JAX package."""
    out = []
    for g in jax_het.group_by_shape([jax_tree(c) for c in clients]):
        idx = np.asarray(g.indices)
        out.append((idx, _stack_np([clients[i] for i in idx]),
                    _stack_np([news[i] for i in idx]),
                    jax.tree_util.tree_map(
                        np.asarray, jax_cov.coverage_pytree(
                            jax_tree(clients[idx[0]]), cov_by_name)),
                    drop[idx].astype(np.float32)))
    return out


def _perturbed(clients, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda x: (x + scale * rng.normal(size=x.shape)).astype(np.float32),
        p) for p in clients]


def _cr(gp, clients):
    return jax_cov.coverage_rates(
        [jax_cov.channel_widths(jax_tree(c)) for c in clients],
        jax_cov.channel_widths(jax_tree(gp)))


@pytest.mark.parametrize("fleet", ["mlp", "vgg"])
@pytest.mark.parametrize("robust", ["mean", "trimmed:0.2", "clip:1.5"])
def test_aggregate_sparse_grouped_matches_jax(fleet, robust):
    """The single canvas equals the group-by-group writes bit for bit
    (with a zero-weight row and a row no group owns), and both are within
    Eq. (4)'s tolerance of the JAX package's grouped aggregation for the
    mean, trimmed and clip variants."""
    gp, clients = _mlp_fleet(6, seed=11) if fleet == "mlp" else \
        _vgg_fleet(6, seed=11)
    news = _perturbed(clients, 3)
    drop = np.linspace(0.0, 0.7, 6)
    rk = np.asarray(jax.random.PRNGKey(5))
    groups = _groups_np(clients, news, drop, rk, _cr(gp, clients))
    weights = np.asarray([1.0, 2.0, 0.0, 3.0, 1.5, 2.5, 4.0], np.float32)
    p_params, p_masks, p_rows, j_params, j_masks, j_rows = ([] for _ in
                                                           range(6))
    for idx, so, sn, _, dr in groups:
        masks, _ = jax_sel.build_masks_batched(
            jax_tree(so), jax_tree(sn), jnp.asarray(dr),
            config=jax_sel.SelectionConfig(), rng=jnp.asarray(rk),
            client_indices=jnp.asarray(idx))
        j_params.append(jax_tree(sn))
        j_masks.append(masks)
        j_rows.append(jnp.asarray(idx))
        p_params.append(convert.to_torch(sn, "cpu"))
        p_masks.append(convert.to_torch(
            jax.tree_util.tree_map(np.asarray, masks), "cpu"))
        p_rows.append(torch.as_tensor(idx, dtype=torch.long))
    kw = dict(prev_global=convert.to_torch(gp, "cpu"), robust=robust)
    fused = aggregation.aggregate_sparse_grouped(
        p_params, p_masks, p_rows, weights, convert.to_torch(gp, "cpu"),
        **kw)
    seq = aggregation.aggregate_sparse_grouped(
        p_params, p_masks, p_rows, weights, convert.to_torch(gp, "cpu"),
        single_canvas=False, **kw)
    assert _trees_equal(fused, seq)
    want = jax_agg.aggregate_sparse_grouped(
        j_params, j_masks, j_rows, jnp.asarray(weights), jax_tree(gp),
        prev_global=jax_tree(gp), robust=robust)
    for g, w in zip(tree.leaves(fused), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np32(g), np32(w), rtol=3e-5, atol=1e-6)


# --- the grouped step ----------------------------------------------------

STEP_CASES = [(fleet, full, comm, dense)
              for fleet in ("mlp", "vgg")
              for full, comm, dense in ((False, "default", False),
                                        (True, "default", False),
                                        (False, "auto8", False),
                                        (True, "auto8", False),
                                        (False, "default", True))
              if fleet == "mlp" or comm == "default"]


@pytest.mark.parametrize("fleet,full_round,comm,dense", STEP_CASES)
def test_grouped_round_step_matches_jax(fleet, full_round, comm, dense):
    """``_grouped_round_step`` against the JAX package's (jitted): the
    global within Eq. (4)'s tolerance, group params within it (Eq. (5) is
    an exact select of the global and the local values), densities within
    one float32 ulp (the port divides as the loop; the JAX step multiplies
    by the reciprocal) and the measured wire overhead exactly."""
    gp, clients = _mlp_fleet(6, seed=3) if fleet == "mlp" else \
        _vgg_fleet(6, seed=3)
    news = _perturbed(clients, 50)
    drop = np.linspace(0.0, 0.75, 6)
    weights = np.arange(1.0, 7.0)
    rk = np.asarray(jax.random.PRNGKey(11))
    groups = _groups_np(clients, news, drop, rk, _cr(gp, clients))
    p_comm, j_comm = ((CommConfig(), JaxComm()) if comm == "default" else
                      (CommConfig("auto", 8), JaxComm("auto", 8)))
    p_batches = [round_engine.GroupBatch(
        indices=idx, stacked_old=convert.to_torch(so, "cpu"),
        stacked_new=convert.to_torch(sn, "cpu"),
        coverage=convert.to_torch(cv, "cpu"), dropout=torch.from_numpy(dr))
        for idx, so, sn, cv, dr in groups]
    j_batches = [jax_re.GroupBatch(
        indices=jnp.asarray(idx, jnp.int32), stacked_old=jax_tree(so),
        stacked_new=jax_tree(sn), coverage=jax_tree(cv),
        dropout=jnp.asarray(dr)) for idx, so, sn, cv, dr in groups]
    got = round_engine.GroupedRoundEngine(comm=p_comm).step(
        p_batches, convert.to_torch(gp, "cpu"), weights, rk,
        full_round=full_round, dense_masks=dense)
    want = jax_re.GroupedRoundEngine(comm=j_comm).step(
        j_batches, jax_tree(gp), weights, jnp.asarray(rk),
        full_round=full_round, dense_masks=dense)
    step = 0.0 if comm == "default" else 1.0 / 127
    for g, w in zip(tree.leaves(got.global_params),
                    jax.tree_util.tree_leaves(want.global_params)):
        w = np32(w)
        np.testing.assert_allclose(np32(g), w, rtol=3e-5,
                                   atol=1e-6 + step * np.abs(w).max())
    for gg, wg in zip(got.group_client_params, want.group_client_params):
        for g, w in zip(tree.leaves(gg), jax.tree_util.tree_leaves(wg)):
            w = np32(w)
            assert g.is_contiguous() and tuple(g.shape) == w.shape
            np.testing.assert_allclose(np32(g), w, rtol=3e-5,
                                       atol=1e-6 + step * np.abs(w).max())
    np.testing.assert_allclose(np32(got.densities), np32(want.densities),
                               rtol=1.2e-7)
    if comm == "default":
        assert got.wire_overhead is None and want.wire_overhead is None
    else:
        np.testing.assert_array_equal(got.wire_overhead.numpy(),
                                      np.asarray(want.wire_overhead))


def test_grouped_step_equals_padded_per_client_maths(one_thread):
    """One grouped step equals, bit for bit, what the per-client loop does
    on a ragged fleet: ``build_masks`` with the client's coverage slice,
    zero-padded uploads and masks through ``aggregate_sparse``, then
    Eq. (5) against the global sliced to each client's widths."""
    gp, clients = _vgg_fleet(5, seed=2)
    news = _perturbed(clients, 7)
    drop = np.linspace(0.0, 0.6, 5)
    weights = np.arange(2.0, 7.0)
    rk = np.asarray(jax.random.PRNGKey(3))
    groups = _groups_np(clients, news, drop, rk, _cr(gp, clients))
    tgp = convert.to_torch(gp, "cpu")
    srv = _port_server(gp, clients, _tel_kw(clients))
    batches = [round_engine.GroupBatch(
        idx, convert.to_torch(so, "cpu"), convert.to_torch(sn, "cpu"),
        coverage.coverage_pytree(srv.clients[idx[0]].params, srv.cr),
        torch.from_numpy(dr)) for idx, so, sn, _, dr in groups]
    out = round_engine.GroupedRoundEngine().step(batches, tgp, weights, rk,
                                                 full_round=False)
    masks, agg_p, agg_m = [], [], []
    for i, cs in enumerate(srv.clients):
        new = convert.to_torch(news[i], "cpu")
        m = selection.build_masks(
            cs.params, new, drop[i],
            coverage=coverage.coverage_pytree(cs.params, srv.cr),
            rng=jax_rng_fold(rk, 10_000 + i))
        masks.append(m)
        agg_p.append(srv._pad_to_global(new))
        agg_m.append(srv._pad_mask_to_global(m, new))
    glob = aggregation.aggregate_sparse(agg_p, agg_m, weights,
                                        prev_global=tgp)
    assert _trees_equal(glob, out.global_params)
    for g, stacked in zip(groups, out.group_client_params):
        for pos, i in enumerate(g[0]):
            new = convert.to_torch(news[i], "cpu")
            want = aggregation.client_update_sparse(
                srv._slice_like(glob, new), new, masks[i])
            assert _trees_equal(tree.tree_map(lambda l: l[pos], stacked),
                                want)


# --- end to end ------------------------------------------------------------

@pytest.mark.parametrize("fleet", ["mlp", "vgg"])
def test_grouped_run_equals_port_loop_bit_for_bit(fleet, one_thread):
    """Algorithm 1 on a ragged fleet, 4 rounds with h = 3 (a full round
    included): the grouped engine and the port's loop give the same
    globals, client params and records (all but the host wall time)."""
    gp, clients = _mlp_fleet(6) if fleet == "mlp" else _vgg_fleet(5)
    tel_kw = _tel_kw(clients)
    kw = dict(scheme="feddd", rounds=4, a_server=0.6, h=3, seed=0)
    loop = _port_server(gp, clients, tel_kw, batched=False, **kw)
    grp = _port_server(gp, clients, tel_kw, **kw)
    assert loop.executor_kind == "loop" and grp.executor_kind == "grouped"
    r_loop, r_grp = loop.run(_ltf_torch), grp.run(_ltf_torch)
    assert _trees_equal(r_loop.global_params, r_grp.global_params)
    for a, b in zip(loop.clients, grp.clients):
        assert _trees_equal(a.params, b.params)
    assert [_record(r) for r in r_loop.history] == [
        _record(r) for r in r_grp.history]
    assert r_grp.history[1].uploaded_fraction < 1.0


@pytest.mark.parametrize("scheme", ["feddd", "fedavg", "fedcs", "oort"])
@pytest.mark.parametrize("fleet", ["mlp", "vgg"])
def test_grouped_run_matches_jax_loop(scheme, fleet):
    """The grouped run against the JAX package's per-client loop: equal
    participants, dropout rates and Eq. (12) clock every round, the
    uploaded fraction within 1e-6 and the parameters within 2e-6 (fp32
    sums of the two packages in other orders)."""
    gp, clients = _mlp_fleet(6, seed=5) if fleet == "mlp" else \
        _vgg_fleet(5, seed=5)
    tel_kw = _tel_kw(clients, seed=1)
    kw = dict(scheme=scheme, rounds=3, a_server=0.6, h=2, seed=0)
    grp = _port_server(gp, clients, tel_kw, **kw)
    assert grp.executor_kind == "grouped"
    got = grp.run(_ltf_torch)
    jsrv, want = _jax_run(gp, clients, tel_kw, batched=False, **kw)
    for g, w in zip(got.history, want.history):
        assert g.participants == w.participants
        assert g.sim_time == w.sim_time
        np.testing.assert_array_equal(g.dropout_rates, w.dropout_rates)
        assert g.uploaded_fraction == pytest.approx(w.uploaded_fraction,
                                                    abs=1e-6)
        assert g.mean_loss == pytest.approx(w.mean_loss, abs=1e-9)
    if scheme != "fedavg":
        assert min(r.participants for r in got.history) <= len(clients)
    for g, w in zip(tree.leaves(got.global_params),
                    jax.tree_util.tree_leaves(want.global_params)):
        np.testing.assert_allclose(np32(g), np32(w), rtol=1e-5, atol=2e-6)
    for cs, js in zip(grp.clients, jsrv.clients):
        for g, w in zip(tree.leaves(cs.params),
                        jax.tree_util.tree_leaves(js.params)):
            np.testing.assert_allclose(np32(g), np32(w), rtol=1e-5,
                                       atol=2e-6)


@pytest.mark.parametrize("variant", ["auto8", "trimmed:0.2", "clip:2.0"])
def test_grouped_run_variants_match_jax_grouped(variant):
    """CommConfig(auto, 8) and the robust Eq. (4) variants on the grouped
    engine against the JAX package's grouped run: equal clock and rates,
    parameters within tolerance (one int8 step for the quantized uploads)."""
    gp, clients = _mlp_fleet(6, seed=8)
    tel_kw = _tel_kw(clients, seed=2)
    if variant == "auto8":
        pkw, jkw = dict(comm=CommConfig("auto", 8)), dict(
            comm=JaxComm("auto", 8))
    else:
        pkw = jkw = dict(robust_agg=variant)
    kw = dict(scheme="feddd", rounds=3, a_server=0.6, h=3, seed=0)
    grp = _port_server(gp, clients, tel_kw, **kw, **pkw)
    got = grp.run(_ltf_torch)
    _, want = _jax_run(gp, clients, tel_kw, **kw, **jkw)
    step = 1.0 / 127 if variant == "auto8" else 0.0
    for g, w in zip(got.history, want.history):
        assert g.sim_time == w.sim_time
        np.testing.assert_array_equal(g.dropout_rates, w.dropout_rates)
        assert g.wire_bytes == pytest.approx(w.wire_bytes, rel=1e-6)
    for g, w in zip(tree.leaves(got.global_params),
                    jax.tree_util.tree_leaves(want.global_params)):
        w = np32(w)
        np.testing.assert_allclose(np32(g), w, rtol=1e-5,
                                   atol=2e-6 + step * np.abs(w).max())


# --- routing and the entry point -------------------------------------------

def test_routing_and_what_raises():
    gp, clients = _mlp_fleet(4)
    tel_kw = _tel_kw(clients)
    assert _port_server(gp, clients, tel_kw).executor_kind == "grouped"
    assert _port_server(gp, clients, tel_kw,
                        batched=False).executor_kind == "loop"
    assert _port_server(gp, clients, tel_kw,
                        track_epsilon=True).executor_kind == "loop"
    homo = [gp] * 4
    srv = _port_server(gp, homo, tel_kw)
    assert not srv.heterogeneous and srv.executor_kind == "engine"
    with pytest.raises(ValueError, match="batched_train_fn"):
        _port_server(gp, clients, tel_kw).run(
            batched_train_fn=lambda p, k: (p, None))
    with pytest.raises(ValueError, match="robust_agg"):
        _port_server(gp, clients, tel_kw, batched=False,
                     robust_agg="trimmed").run(_ltf_torch)
    with pytest.raises(ValueError, match="rounds_per_dispatch"):
        _port_server(gp, clients, tel_kw, allocator="jax",
                     rounds_per_dispatch=2).run(_ltf_torch)
    from repro_torch.launch.mesh import ClientMesh
    with pytest.raises(ValueError, match="clients"):
        round_engine.GroupedRoundEngine(mesh=ClientMesh(("cpu",), ("pod",)))
    with pytest.raises(NotImplementedError, match="robust_agg"):
        round_engine.GroupedRoundEngine(mesh=ClientMesh(("cpu",)),
                                        robust_agg="trimmed")
    assert round_engine.GroupedRoundEngine(
        mesh=ClientMesh(("cpu",) * 2)).mesh.num_shards == 2
    # epsilon on a ragged fleet runs the loop's padded uploads
    res = _port_server(gp, clients, tel_kw, rounds=2,
                       track_epsilon=True).run(_ltf_torch)
    assert all(np.isfinite(r.epsilon) for r in res.history)


def test_heterogeneous_entry_point_grouped_and_loop(one_thread):
    """``python -m repro_torch.heterogeneous --device cpu`` at a reduced
    size runs the grouped engine and, with ``--loop``, the per-client
    loop; both print the same accuracies, rates and uploads."""
    from repro_torch import heterogeneous

    def run(*extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            heterogeneous.main(["--device", "cpu", "--rounds", "2",
                                "--num-train", "100", "--num-test", "40",
                                *extra])
        return buf.getvalue().splitlines()

    grouped, loop = run(), run("--loop")
    assert "executor: grouped" in grouped[1]
    assert "executor: loop" in loop[1]
    assert grouped[0] == loop[0] and grouped[2] == loop[2]
    strip = [ln.rsplit(" host=", 1)[0] for ln in grouped[3:]]
    assert strip == [ln.rsplit(" host=", 1)[0] for ln in loop[3:]]
    assert len(strip) == 2 and strip[1].startswith("round 2: acc=")
