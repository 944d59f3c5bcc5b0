"""The per-client reference loop, FedCS/Oort, coverage and the Theorem 2
diagnostics of the PyTorch port against the JAX package.

* ``run_scheme(..., batched=False, track_epsilon=True)`` of the port
  against the JAX package's loop over 3 quickstart-configuration rounds
  with the real trainer: equal dropout rates, bytes, Eq. (12) clock and
  record fields; parameters within 1e-6 (plus one fp16/int8 step where
  the uploads are quantized); epsilon within rtol 1e-5 (fp32 sums over
  every leaf, added in another order).
* The port's loop against the port's engine: parameters, masks, rates,
  clock, losses and accuracy bit for bit.  The per-client densities
  differ by at most one float32 ulp, and an int8 upload's scale by one:
  the JAX package's loop divides (``kept / total``, ``max|x| / 127``)
  and its jitted engine multiplies by the float32 reciprocal, and each
  port path follows its twin exactly.
* FedCS and Oort on the engine (and on the loop) against the JAX
  package's engine: equal participants, rates and clock every round.
* The selectors, coverage, ``keystr``, the per-client masks and
  aggregation, ``estimate_epsilon`` and the Theorem 2 functions on seeded
  inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jax_agg
from repro.core import baselines as jax_baselines
from repro.core import convergence as jax_conv
from repro.core import coverage as jax_cov
from repro.core import protocol as jax_protocol
from repro.core import selection as jax_sel
from repro.core.allocation import ClientTelemetry as JaxTelemetry
from repro.data import partition as jax_part
from repro.data import synthetic as jax_synth
from repro.fl import heterogeneity as jax_het
from repro.fl import models as jax_models
from repro_torch import convert, prng, tree
from repro_torch.core import (aggregation, baselines, convergence, coverage,
                              protocol, selection)
from repro_torch.core.allocation import ClientTelemetry
from repro_torch.data import partition, synthetic
from repro_torch.fl import heterogeneity, models

from test_torch_protocol import (N_CLIENTS, RECORD_EQUAL, _jax_params,
                                 _quickstart_pieces)
from torch_parity import np32

ROUNDS = 3


@pytest.fixture
def one_thread():
    """Runs of the real trainer held to exact fields: one intra-op thread,
    so the CPU's float32 GEMMs and sums take one blocking in every run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run_jax(scheme="feddd", **kw):
    params = _jax_params()
    tel, ltf, ef = _quickstart_pieces(jax_synth, jax_part, jax_het,
                                      jax_models)
    return jax_protocol.run_scheme(
        scheme, jax.tree_util.tree_map(jnp.asarray, params), tel, ltf, ef,
        rounds=ROUNDS, a_server=0.6, h=5, seed=0, **kw)


def _run_torch(scheme="feddd", **kw):
    params = _jax_params()
    tel, ltf, ef = _quickstart_pieces(synthetic, partition, heterogeneity,
                                      models, device="cpu")
    return protocol.run_scheme(
        scheme, convert.to_torch(params, "cpu"), tel, ltf, ef,
        rounds=ROUNDS, a_server=0.6, h=5, seed=0, device="cpu", **kw)


def _comm_kw(codec, qbits):
    from repro.comm.payload import CommConfig as JaxComm
    from repro_torch.comm import CommConfig
    return (dict(comm=JaxComm(codec=codec, qbits=qbits)),
            dict(comm=CommConfig(codec=codec, qbits=qbits)))


@pytest.mark.parametrize("scheme,codec,qbits", [
    ("feddd", "dense", 32), ("feddd", "auto", 8), ("random", "index", 16)])
def test_loop_matches_the_jax_loop(scheme, codec, qbits, one_thread):
    from repro.core.selection import SelectionConfig as JaxSel
    jkw, tkw = _comm_kw(codec, qbits)
    want = _run_jax(selection=JaxSel(scheme=scheme), batched=False,
                    track_epsilon=True, **jkw)
    got = _run_torch(selection=selection.SelectionConfig(scheme=scheme),
                     batched=False, track_epsilon=True, **tkw)
    assert len(got.history) == len(want.history) == ROUNDS
    for g, w in zip(got.history, want.history):
        np.testing.assert_array_equal(g.dropout_rates, w.dropout_rates)
        for field in RECORD_EQUAL:
            if field != "epsilon":
                assert getattr(g, field) == getattr(w, field), field
        np.testing.assert_allclose(g.mean_loss, w.mean_loss, rtol=1e-6)
        assert w.epsilon is not None and np.isfinite(g.epsilon)
        np.testing.assert_allclose(g.epsilon, w.epsilon, rtol=1e-5,
                                   atol=1e-12)
    assert got.history[2].epsilon > 0.0
    step = {32: 0.0, 16: 2.0 ** -11, 8: 1.0 / 127}[qbits]
    for g, w in zip(tree.leaves(got.global_params),
                    jax.tree_util.tree_leaves(want.global_params)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 + step * np.abs(w).max())


def _density_ulps(got_bytes, want_bytes, model_bytes):
    """|got - want| in float32 ulps of a density near 1, summed over the
    clients (each client's density may sit one ulp apart)."""
    return abs(got_bytes - want_bytes) / (np.finfo(np.float32).eps
                                          * model_bytes)


@pytest.mark.parametrize("scheme,codec,qbits", [
    ("feddd", "dense", 32), ("random", "auto", 16), ("feddd", "bitmask", 16),
    ("feddd", "bitmask", 8)])
def test_loop_matches_the_engine(scheme, codec, qbits, one_thread):
    """Bit for bit, but for the densities (one float32 ulp a client) and,
    with int8 uploads, the scale: the loop's is the true quotient of the
    JAX package's eager loop, the engine's the reciprocal product of its
    jitted engine, so an int8 round stays within one step (as the JAX
    package's own int8 engine-vs-loop contract)."""
    _, tkw = _comm_kw(codec, qbits)
    sel = selection.SelectionConfig(scheme=scheme)
    loop = _run_torch(selection=sel, batched=False, **tkw)
    eng = _run_torch(selection=sel, **tkw)
    exact = qbits != 8
    model_bytes = 341_656
    for lr, er in zip(loop.history, eng.history):
        np.testing.assert_array_equal(lr.dropout_rates, er.dropout_rates)
        for field in ("round", "sim_time", "sim_round_time", "participants",
                      "survivors") + (("mean_loss", "metrics") if exact
                                      else ()):
            assert getattr(lr, field) == getattr(er, field), field
        np.testing.assert_allclose(lr.mean_loss, er.mean_loss, rtol=1e-5)
        assert lr.epsilon is None and er.epsilon is None
        for field in ("uploaded_bytes", "wire_bytes"):
            assert _density_ulps(getattr(lr, field), getattr(er, field),
                                 model_bytes) <= N_CLIENTS, field
    for a, b in zip(tree.leaves(loop.global_params),
                    tree.leaves(eng.global_params)):
        if exact:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=b.abs().max().item() / 127)


def test_exact_scale_qdq_equals_the_jax_eager_qdq():
    """The loop's int8 QDQ (``exact_scale``) equals the JAX package's eager
    per-client QDQ bit for bit."""
    from repro.comm import quantize as jquant
    from repro_torch.comm import quantize
    rng = np.random.default_rng(8)
    params = {"a": {"w": rng.normal(size=(37, 11)).astype(np.float32)},
              "b": [(rng.normal(size=(64,)) * 3).astype(np.float32)]}
    for i in range(8):
        key = jquant.client_quant_key(jax.random.PRNGKey(i), i)
        want = jquant.quantize_dequantize(
            jax.tree_util.tree_map(jnp.asarray, params), key, 8)
        got = quantize.quantize_dequantize(
            tree.tree_map(torch.from_numpy, params), np.asarray(key), 8,
            exact_scale=True)
        for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scheme", ["fedcs", "oort"])
@pytest.mark.parametrize("batched", [True, False], ids=["engine", "loop"])
def test_baselines_match_the_jax_engine(scheme, batched, one_thread):
    want = _run_jax(scheme)
    got = _run_torch(scheme, batched=batched)
    for g, w in zip(got.history, want.history):
        assert g.participants == w.participants < N_CLIENTS
        np.testing.assert_array_equal(g.dropout_rates, w.dropout_rates)
        for field in ("sim_time", "sim_round_time", "uploaded_bytes",
                      "wire_bytes", "uploaded_fraction", "survivors"):
            assert getattr(g, field) == getattr(w, field), field
        assert g.uploaded_fraction <= 0.6 + 1e-9
        np.testing.assert_allclose(g.mean_loss, w.mean_loss, rtol=1e-6)
    for g, w in zip(tree.leaves(got.global_params),
                    jax.tree_util.tree_leaves(want.global_params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_executor_routing():
    from repro_torch.fl import MLP_SPEC, init_cnn_spec
    params = init_cnn_spec(MLP_SPEC, device="cpu")
    tel = heterogeneity.sample_system_telemetry(2, [1e5, 1e5], [10, 10],
                                                [1.0, 1.0])
    kinds = {}
    for kw in ({}, dict(batched=False), dict(track_epsilon=True),
               dict(scheme="oort")):
        cfg = protocol.ProtocolConfig(**kw)
        kinds[tuple(kw.items())] = protocol.FedDDServer(
            params, cfg, tel, device="cpu").executor_kind
    assert list(kinds.values()) == ["engine", "loop", "loop", "engine"]


# ---------------------------------------------------------------- pieces

def _telemetry(rng, n, tied):
    kw = dict(model_bytes=rng.uniform(1e5, 4e5, n),
              uplink_rate=rng.uniform(1e3, 5e3, n),
              downlink_rate=rng.uniform(5e3, 2e4, n),
              compute_latency=rng.uniform(1.0, 5.0, n),
              num_samples=rng.integers(10, 50, n).astype(float),
              label_coverage=rng.uniform(0.5, 1.0, n),
              train_loss=rng.uniform(0.0, 2.0, n))
    if tied:   # identical clients: tied round times and utilities
        for k in kw:
            kw[k][n // 2:] = kw[k][0]
    return kw


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("tied", [False, True], ids=["generic", "tied"])
def test_selectors_match_jax(seed, tied):
    rng = np.random.default_rng(seed)
    kw = _telemetry(rng, 12, tied)
    jt, tt = JaxTelemetry(**kw), ClientTelemetry(**kw)
    for a in (0.1, 0.35, 0.6, 1.0):
        np.testing.assert_array_equal(
            baselines.select_fedcs(tt, a_server=a),
            jax_baselines.select_fedcs(jt, a_server=a))
        np.testing.assert_array_equal(
            baselines.select_oort(tt, a_server=a),
            jax_baselines.select_oort(jt, a_server=a))
    for dl in (None, 5.0):
        np.testing.assert_array_equal(
            baselines.oort_system_penalty(tt, round_deadline=dl),
            jax_baselines.oort_system_penalty(jt, round_deadline=dl))
    np.testing.assert_array_equal(
        baselines.OortState(3.0).utilities(tt),
        jax_baselines.OortState(3.0).utilities(jt))


def test_keystr_matches_jax():
    t = {"b": [1, {"y": 2, "x": [3, 4]}], "a": {"w": 5}, "c": [[6], [],
                                                              {"z": 7}]}
    want = [(jax.tree_util.keystr(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(t)[0]]
    got = [(tree.keystr(p), leaf) for p, leaf in
           tree.flatten_with_path(t)[0]]
    assert got == want
    assert tree.leaves(t) == jax.tree_util.tree_leaves(t)
    assert tree.unflatten(tree.flatten(t)[1], tree.leaves(t)) == t


def _ragged(seed):
    rng = np.random.default_rng(seed)
    full = {"fc0": {"w": rng.normal(size=(6, 12)).astype(np.float32),
                    "b": np.zeros(12, np.float32)},
            "fc1": [rng.normal(size=(12, 5)).astype(np.float32)]}
    subs = [{"fc0": {"w": full["fc0"]["w"][:, :w], "b": full["fc0"]["b"][:w]},
             "fc1": [full["fc1"][0][:w]]} for w in (12, 8, 5)]
    subs.append({"fc0": full["fc0"]})        # a client without fc1
    return full, subs


def test_coverage_matches_jax():
    full, subs = _ragged(0)
    want_w = [jax_cov.channel_widths(s) for s in subs]
    got_w = [coverage.channel_widths(s) for s in subs]
    assert got_w == want_w
    want_cr = jax_cov.coverage_rates(want_w, jax_cov.channel_widths(full))
    got_cr = coverage.coverage_rates(got_w, coverage.channel_widths(full))
    assert sorted(got_cr) == sorted(want_cr)
    for k in want_cr:
        np.testing.assert_array_equal(got_cr[k], want_cr[k])
        assert got_cr[k].dtype == want_cr[k].dtype
    for s in subs:
        want = jax_cov.coverage_pytree(s, want_cr)
        got = coverage.coverage_pytree(tree.tree_map(torch.from_numpy, s),
                                       got_cr)
        for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    missing = coverage.coverage_pytree(
        tree.tree_map(torch.from_numpy, subs[0]), {})
    assert all(bool((l == 1).all()) for l in tree.leaves(missing))


def test_theorem2_functions_match_jax():
    for L in (0.5, 1.0, 10.0):                         # noqa: N806
        for eps in (0.0, 0.01, 0.3, 2.0):
            assert convergence.eta_max(L, eps) == jax_conv.eta_max(L, eps)
            for eta in (0.001, 0.05, 0.5, 3.0):
                for h in (1, 5, 20):
                    kw = dict(L=L, eta=eta, eps=eps, sigma_sq_mean=0.7,
                              f0_minus_fstar=2.5, h=h, T=10 * h)
                    g = convergence.BoundInputs(**kw)
                    w = jax_conv.BoundInputs(**kw)
                    assert (convergence.theorem2_bound(g)
                            == jax_conv.theorem2_bound(w))
                    assert (convergence.residual_error(g)
                            == jax_conv.residual_error(w))


def _client_pair(rng, dtype=np.float32):
    old = {"conv": {"k": rng.normal(size=(3, 3, 4, 16)).astype(dtype)},
           "fc": [{"w": rng.normal(size=(64, 10)).astype(dtype),
                   "b": rng.normal(size=(10,)).astype(dtype)}]}
    new = jax.tree_util.tree_map(
        lambda x: (x + 0.1 * rng.normal(size=np.shape(x))).astype(np.float32),
        old)
    return old, new


@pytest.mark.parametrize("scheme", jax_sel.SCHEMES)
@pytest.mark.parametrize("rate", [0.0, 0.37, 0.8])
def test_build_masks_matches_jax(scheme, rate):
    rng = np.random.default_rng(11)
    old, new = _client_pair(rng)
    key = prng.fold_in(prng.PRNGKey(4), 10_003)
    cov_np = {"['conv']['k']": rng.uniform(0.2, 1.0, 16).astype(np.float32)}
    up = (lambda name: name == "['fc'][0]['b']")
    want = jax_sel.build_masks(
        jax.tree_util.tree_map(jnp.asarray, old),
        jax.tree_util.tree_map(jnp.asarray, new),
        jnp.asarray(rate, jnp.float32), config=jax_sel.SelectionConfig(
            scheme=scheme), rng=jnp.asarray(key),
        coverage=jax_cov.coverage_pytree(new, cov_np), always_upload=up)
    tnew = tree.tree_map(torch.from_numpy, tree.tree_map(np.asarray, new))
    got = selection.build_masks(
        tree.tree_map(torch.from_numpy, tree.tree_map(np.asarray, old)),
        tnew, rate, config=selection.SelectionConfig(scheme=scheme), rng=key,
        coverage=coverage.coverage_pytree(tnew, cov_np), always_upload=up)
    for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(np32(g), np32(w))
    assert float(selection.mask_density(tnew, got)) == float(
        jax_sel.mask_density(jax.tree_util.tree_map(jnp.asarray, new), want))
    np.testing.assert_array_equal(
        np32(selection.apply_mask(tnew, got)["fc"][0]["w"]),
        np32(jax_sel.apply_mask(new, want)["fc"][0]["w"]))


def test_per_client_aggregation_and_update_match_jax():
    """aggregate_sparse over lists (the loop's Eq. (4)), the per-client
    Eq. (5) and estimate_epsilon against the JAX package."""
    rng = np.random.default_rng(5)
    pairs = [_client_pair(rng) for _ in range(4)]
    rates = [0.0, 0.3, 0.6, 0.9]
    jmasks, tmasks, tnews = [], [], []
    for (old, new), r in zip(pairs, rates):
        jmasks.append(jax_sel.build_masks(old, new, jnp.float32(r)))
        tnew = tree.tree_map(torch.from_numpy, tree.tree_map(np.asarray,
                                                             new))
        tnews.append(tnew)
        tmasks.append(selection.build_masks(
            tree.tree_map(torch.from_numpy, tree.tree_map(np.asarray, old)),
            tnew, r))
    weights = [30, 10, 25, 5]
    gprev = pairs[0][0]
    want = jax_agg.aggregate_sparse(
        [p[1] for p in pairs],
        [jax.tree_util.tree_map(lambda m, x: jnp.broadcast_to(m, x.shape),
                                m, p[1]) for m, p in zip(jmasks, pairs)],
        weights, prev_global=gprev)
    tprev = tree.tree_map(torch.from_numpy, tree.tree_map(np.asarray, gprev))
    got = aggregation.aggregate_sparse(tnews, tmasks, weights,
                                       prev_global=tprev)
    for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np32(g), np32(w), rtol=3e-5, atol=1e-6)
    for tn, tm, (_, new), jm in zip(tnews, tmasks, pairs, jmasks):
        upd = aggregation.client_update_sparse(got, tn, tm)
        wupd = jax_agg.client_update_sparse(
            jax.tree_util.tree_map(jnp.asarray,
                                   tree.tree_map(lambda x: x.numpy(), got)),
            new, jm)
        for g, w in zip(tree.leaves(upd), jax.tree_util.tree_leaves(wupd)):
            np.testing.assert_array_equal(np32(g), np32(w))
    eps = float(convergence.estimate_epsilon(tnews, tmasks))
    weps = float(jax_conv.estimate_epsilon([p[1] for p in pairs], jmasks))
    assert eps > 0
    np.testing.assert_allclose(eps, weps, rtol=1e-5)
