"""The wire formats of the PyTorch port (``repro_torch.comm``) against the
JAX package's ``repro.comm``.

* Byte formulas (varint, bitmask, index, the stacked and per-client
  measured overheads, the full-upload constant, the analytic model and
  the collective model) and the serialized masks are equal, for every
  codec at densities 0 to 1; ``len(encode_mask)`` is the formula and
  ``decode_mask`` inverts it.
* Value codecs: fp16 is exact; int8 codes and scales equal the JAX
  package's jitted engine's (it computes max|x| / 127 as a multiply by
  the float32 reciprocal), values equal too, and within one scale step
  of the input (the int8 bound of ``repro/comm/quantize.py``'s
  docstring); against its eager rendering, within one scale step.
* ``encode_upload`` / ``decode_upload`` give the JAX package's bytes and
  values; the overhead-aware LP gives its numpy solver's rates exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.comm import payload as jpayload
from repro.comm import quantize as jquant
from repro.core import allocation as jalloc
from repro.fl import heterogeneity as jhet
from repro_torch import tree
from repro_torch.comm import codecs, payload, quantize
from repro_torch.core import allocation
from repro_torch.fl import heterogeneity

from torch_parity import jax_tree, torch_tree

CODECS = ("dense", "bitmask", "index", "auto")
DENSITIES = (0.0, 0.04, 0.3, 0.7, 1.0)
MLP = {"fc0": {"w": (784, 100), "b": (100,)},
       "fc1": {"w": (100, 64), "b": (64,)},
       "fc2": {"w": (64, 10), "b": (10,)}}


def _mask(rng, c, density, lead=()):
    return (rng.uniform(size=lead + (c,)) < density).astype(np.float32)


def _stacked_masks(rng, n, density):
    """Engine-shaped masks of the MLP: (N, 1, C) and (N, C), one density
    each client around ``density``."""
    out = {}
    for k, v in MLP.items():
        out[k] = {}
        for p, s in v.items():
            m = _mask(rng, s[-1], density, (n,))
            out[k][p] = m.reshape((n,) + (1,) * (len(s) - 1) + s[-1:])
    return out


def test_varint_and_bitmask_bytes_equal_jax():
    vals = np.array([0, 1, 127, 128, 16383, 16384, 2 ** 21 - 1, 2 ** 21,
                     2 ** 28 - 1, 2 ** 28, 2 ** 31 - 1], np.int32)
    want = np.asarray(jcodecs.varint_bytes(vals, np))
    np.testing.assert_array_equal(codecs.varint_bytes(vals), want)
    np.testing.assert_array_equal(
        codecs.varint_bytes(torch.from_numpy(vals)).numpy(), want)
    for c in (1, 7, 8, 9, 100, 513):
        assert codecs.bitmask_bytes(c) == jcodecs.bitmask_bytes(c)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("c", [1, 10, 100, 300, 2000])
def test_index_bytes_equal_jax(c, density):
    rng = np.random.default_rng(c)
    m = _mask(rng, c, density, (6,))
    want = np.asarray(jcodecs.index_bytes(jnp.asarray(m)))
    np.testing.assert_array_equal(codecs.index_bytes(m), want)


@pytest.mark.parametrize("qbits", [32, 16, 8])
@pytest.mark.parametrize("codec", CODECS)
def test_mask_overheads_equal_jax(codec, qbits):
    """Stacked (torch) and per-client (numpy) overheads at every density,
    and the full-upload constant of the MLP."""
    rng = np.random.default_rng(qbits)
    jc = jpayload.CommConfig(codec=codec, qbits=qbits)
    tc = payload.CommConfig(codec=codec, qbits=qbits)
    params = {k: {p: np.zeros((5,) + s, np.float32) for p, s in v.items()}
              for k, v in MLP.items()}
    for density in DENSITIES:
        masks = _stacked_masks(rng, 5, density)
        want = np.asarray(jcodecs.mask_overhead_bytes_stacked(
            jax_tree(masks), jax_tree(params), jc))
        got = codecs.mask_overhead_bytes_stacked(torch_tree(masks),
                                                 torch_tree(params), tc)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        for i in range(5):
            one = tree.tree_map(lambda m: m[i][None], masks)
            assert codecs.mask_overhead_bytes(one, None, tc) == \
                jcodecs.mask_overhead_bytes(jax_tree(one), None, jc) == \
                want[i]
    spec_j = jpayload.WireSpec.from_params(
        jax.tree_util.tree_map(lambda s: jnp.zeros(s), MLP,
                               is_leaf=lambda x: isinstance(x, tuple)))
    spec_t = payload.WireSpec.from_stacked(torch_tree(params))
    assert spec_t == payload.WireSpec(spec_j.leaves)
    assert codecs.full_upload_overhead_bytes(spec_t, tc) == \
        jcodecs.full_upload_overhead_bytes(spec_j, jc)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("codec", CODECS)
def test_encode_and_decode_mask_equal_jax(codec, density):
    rng = np.random.default_rng(int(density * 100))
    for c in (1, 9, 100, 1000):
        m = _mask(rng, c, density)
        buf = codecs.encode_mask(m, codec)
        assert buf == jcodecs.encode_mask(m, codec)
        want_len = (int(jcodecs._leaf_overhead(m[None], c, codec, np)[0]))
        assert len(buf) == want_len
        dec = codecs.decode_mask(buf, c, codec)
        np.testing.assert_array_equal(dec, jcodecs.decode_mask(buf, c,
                                                               codec))
        if codec != "dense":
            np.testing.assert_array_equal(dec, m)


def _jit_qdq(x, qbits, key):
    return jax.jit(lambda x, k: jquant.quantize_leaf(x, qbits, k))(x, key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_leaf_equals_jax(dtype):
    rng = np.random.default_rng(3)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for i, scale in enumerate((1e-3, 0.3, 1.0, 17.0, 0.0)):
        x = (rng.normal(size=(37, 11)) * scale).astype(np.float32)
        jx = jnp.asarray(x).astype(jdt)
        tx = torch.from_numpy(x).to(tdt)
        c16, _ = quantize.quantize_leaf(tx, 16)
        np.testing.assert_array_equal(
            c16.float().numpy(),
            np.asarray(jquant.quantize_leaf(jx, 16)[0]).astype(np.float32))
        key = jax.random.fold_in(jax.random.PRNGKey(i), 20_000 + i)
        jc, js = _jit_qdq(jx, 8, key)
        tc, ts = quantize.quantize_leaf(tx, 8, np.asarray(key))
        assert tc.dtype == torch.int8
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert float(ts) == float(js)
        got = quantize.qdq_leaf(tx, 8, np.asarray(key))
        want = jax.jit(lambda x, k: jquant.qdq_leaf(x, 8, k))(jx, key)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))
        step = float(ts)
        xf = tx.float().numpy()
        assert np.all(np.abs(got.float().numpy() - xf)
                      <= step * (1 + 1e-6) + (0.0 if dtype == "float32"
                                              else 2 ** -7 * np.abs(xf)))
        eager = np.asarray(jquant.qdq_leaf(jx, 8, key)).astype(np.float32)
        assert np.all(np.abs(got.float().numpy() - eager)
                      <= step * (1 + 1e-6) + 2 ** -7 * np.abs(eager))


@pytest.mark.parametrize("qbits", [16, 8])
def test_quantize_dequantize_stacked_and_per_client_equal_jax(qbits):
    """The stacked QDQ equals the JAX package's jitted stacked QDQ, and
    each client's row equals the port's per-client QDQ under
    ``client_quant_key``."""
    rng = np.random.default_rng(qbits)
    stacked = {k: {p: rng.normal(size=(4,) + s).astype(np.float32)
                   for p, s in v.items()} for k, v in MLP.items()}
    stacked["s"] = rng.normal(size=(4,)).astype(np.float32)
    rk = jax.random.PRNGKey(11)
    want = jax.jit(lambda s, k: jquant.quantize_dequantize_stacked(
        s, k, qbits))(jax_tree(stacked), rk)
    got = quantize.quantize_dequantize_stacked(torch_tree(stacked),
                                               np.asarray(rk), qbits)
    for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for i in range(4):
        one = tree.tree_map(lambda l: l[i], torch_tree(stacked))
        mine = quantize.quantize_dequantize(
            one, quantize.client_quant_key(np.asarray(rk), i), qbits)
        for a, b in zip(tree.leaves(mine), tree.leaves(got)):
            np.testing.assert_array_equal(a.numpy(), b[i].numpy())


@pytest.mark.parametrize("qbits", [32, 16, 8])
@pytest.mark.parametrize("codec", CODECS)
def test_encode_and_decode_upload_equal_jax(codec, qbits):
    rng = np.random.default_rng(7)
    params = {k: {p: rng.normal(size=s).astype(np.float32)
                  for p, s in v.items()} for k, v in MLP.items()}
    masks = {k: {p: _mask(rng, s[-1], 0.4).reshape((1,) * (len(s) - 1)
                                                   + s[-1:])
                 for p, s in v.items()} for k, v in MLP.items()}
    key = jquant.client_quant_key(jax.random.PRNGKey(2), 3)
    jc = jpayload.CommConfig(codec=codec, qbits=qbits)
    tc = payload.CommConfig(codec=codec, qbits=qbits)
    jp = jpayload.encode_upload(jax_tree(params), jax_tree(masks), jc, key)
    tp = payload.encode_upload(torch_tree(params), torch_tree(masks), tc,
                               np.asarray(key))
    assert tp.nbytes == jp.nbytes
    for a, b in zip(tp.leaves, jp.leaves):
        assert (a.mask_bytes, a.value_bytes, a.scale, a.num_channels,
                a.shape, a.channel_axis) == (b.mask_bytes, b.value_bytes,
                                             b.scale, b.num_channels,
                                             b.shape, b.channel_axis)
    kept = sum(int(np.broadcast_to(m, p.shape).sum())
               for m, p in zip(tree.leaves(masks), tree.leaves(params)))
    assert tp.nbytes == codecs.mask_overhead_bytes(
        masks, params, tc) + kept * quantize.value_bytes(qbits)
    vals, msks = payload.decode_upload(tp)
    jvals, jmsks = jpayload.decode_upload(jp)
    for a, b in zip(tree.leaves(vals), jax.tree_util.tree_leaves(jvals)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tree.leaves(msks), jax.tree_util.tree_leaves(jmsks)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("qbits", [32, 16, 8])
@pytest.mark.parametrize("codec", CODECS)
def test_analytic_and_collective_models_equal_jax(codec, qbits):
    spec = payload.WireSpec(((100, 100), (100, 78400), (64, 64),
                             (64, 6400), (10, 10), (10, 640), (1, 1)))
    jspec = jpayload.WireSpec(spec.leaves)
    tc = payload.CommConfig(codec=codec, qbits=qbits)
    jc = jpayload.CommConfig(codec=codec, qbits=qbits)
    d = np.linspace(0.0, 1.0, 23)
    np.testing.assert_array_equal(
        payload.analytic_wire_bytes(spec, d, tc),
        jpayload.analytic_wire_bytes(jspec, d, jc, xp=np))
    np.testing.assert_array_equal(
        payload.analytic_uplink_vector([spec] * 23, d, tc),
        jpayload.analytic_uplink_vector([jspec] * 23, d, jc))
    total = float(payload.analytic_wire_bytes(spec, 0.3, tc))
    for cut in (0.0, 5.0, 0.37 * total, total, 2 * total):
        np.testing.assert_array_equal(
            payload.delivered_prefix_counts(spec, 0.3, tc, cut),
            jpayload.delivered_prefix_counts(jspec, 0.3, jc, cut))
    for mode, k in (("dense", 1.0), ("sparse", 0.35)):
        assert payload.account_collective(spec, 3, mode=mode, k_fraction=k) \
            == jpayload.account_collective(jspec, 3, mode=mode, k_fraction=k)
    dens = np.array([1.0, 0.61, 0.0, 0.4], np.float32)
    part = np.array([True, True, False, True])
    oh = np.array([300, 90, 7, 12], np.int32)
    assert payload.account_uplink(dens, part, [4e5] * 4, oh, tc) == \
        jpayload.account_uplink(dens, part, [4e5] * 4, oh, jc)


def test_comm_config_validates_like_jax():
    assert payload.CommConfig().is_default
    assert not payload.CommConfig(codec="auto").is_default
    assert not payload.CommConfig(qbits=16).is_default
    with pytest.raises(ValueError, match="codec"):
        payload.CommConfig(codec="zip")
    with pytest.raises(ValueError, match="qbits"):
        payload.CommConfig(qbits=4)
    with pytest.raises(ValueError, match="qbits"):
        quantize.value_bytes(12)
    assert [quantize.scale_bytes(q) for q in (32, 16, 8)] == [0, 0, 4]


@pytest.mark.parametrize("codec,qbits", [("bitmask", 32), ("index", 8),
                                         ("auto", 8), ("auto", 16)])
def test_overhead_aware_allocation_equals_jax(codec, qbits):
    rng = np.random.default_rng(5)
    n = 10
    mb = [341_656.0] * n
    kw = dict(num_samples=rng.integers(300, 900, n),
              label_coverage=rng.uniform(1, 3, n))
    tel_t = heterogeneity.sample_system_telemetry(n, mb, kw["num_samples"],
                                                  kw["label_coverage"],
                                                  seed=2)
    tel_j = jhet.sample_system_telemetry(n, mb, kw["num_samples"],
                                         kw["label_coverage"], seed=2)
    losses = rng.uniform(0.2, 2.0, n)
    tel_t = dataclasses.replace(tel_t, train_loss=losses)
    tel_j = dataclasses.replace(tel_j, train_loss=losses)
    spec = ((100, 100), (100, 78400), (64, 64), (64, 6400), (10, 10),
            (10, 640))
    args = dict(a_server=0.6, d_max=0.8, delta=1.0,
                global_model_bytes=mb[0])
    want = jalloc.solve_dropout_rates_overhead_aware(
        tel_j, [jpayload.WireSpec(spec)] * n,
        comm=jpayload.CommConfig(codec=codec, qbits=qbits,
                                 overhead_aware_allocation=True), **args)
    tc = payload.CommConfig(codec=codec, qbits=qbits,
                            overhead_aware_allocation=True)
    got = allocation.solve_dropout_rates_with(
        "numpy", tel_t, comm=tc, wire_specs=[payload.WireSpec(spec)] * n,
        **args)
    np.testing.assert_array_equal(got.dropout_rates, want.dropout_rates)
    assert (got.t_server, got.objective, got.feasible) == (
        want.t_server, want.objective, want.feasible)
    plain = allocation.solve_dropout_rates_with("numpy", tel_t, **args)
    assert not np.array_equal(plain.dropout_rates, got.dropout_rates)
