"""The port's fault layer (``repro_torch.sim.faults``, ``.outages``), the
deadline-prefix masks and the engine step's fault inputs, against the
JAX package.

* fault, outage and corruption draws are numpy and equal the JAX
  package's exactly (every field of every epoch, the corrupted bits);
* ``truncate_masks_to_prefix`` equals the JAX package's exactly, and the
  engine step with ``stacked_upload`` (rows holding NaN, Inf, a flipped
  bit) and ``delivered`` gives the JAX package's masks exactly and its
  Eq. (4) to 3e-5 (``equal_nan``), Eq. (5) with the full masks;
* ``screen_quarantine`` exactly, ``update_stats_stacked`` to rtol 1e-6
  (float32 sums in another order), ``host_update_stats`` exactly;
* a faulty Markov run (crash, loss, mix corruption, quorum, deadline with
  partial aggregation) equals ``repro.sim.run_sim``: the event trace and
  the failure accounting exactly, ``sim_time`` to rtol 1e-6, global
  params to atol 1e-5;
* the JAX package's hand-computed cases (a scripted crash's survivor
  Eq. (4) and clock, scripted retransmits), zero-rate transparency,
  quarantine == crash bit for bit, and the same faulty run in two
  processes.
"""

import hashlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.core import aggregation as jagg
from repro.core import round_engine as jre
from repro.core import selection as jsel
from repro.sim import faults as jfaults
from repro_torch import sim, tree
from repro_torch.core import aggregation, baselines, round_engine, selection
from repro_torch.core import protocol
from repro_torch.sim import faults

from torch_sim_parity import (assert_close_to_jax, j_params, ltf_jax,
                              ltf_torch, np_params, t_params, telemetry,
                              trees_equal)

FIELDS = ("crashed", "crash_frac", "aborted", "retries", "extra_bytes",
          "extra_delay", "sent_bytes", "corrupt")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _faults_equal(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.outages == b.outages


# --- draws: exactly the JAX package's ----------------------------------------

@pytest.mark.parametrize("kw", [
    dict(crash_rate=0.35, loss_rate=0.3, corrupt_rate=0.25, max_retries=3,
         seed=4),
    dict(crash_rate=0.175, loss_rate=0.35, corrupt_rate=0.0875,
         corrupt_kind="mix", quorum=0.25, seed=0),
    dict(loss_rate=0.6, chunk_bytes=512.0, max_retries=1, seed=9),
    dict(corrupt_rate=0.5, corrupt_kind="bitflip", seed=2)])
def test_random_fault_draws_equal_jax_package(kw):
    rng = np.random.default_rng(1)
    wire = rng.uniform(2e3, 2e5, 9)
    up = rng.uniform(1e3, 5e3, 9)
    a, b = sim.RandomFaults(**kw), jsim.RandomFaults(**kw)
    for e in (0, 1, 5, 2):
        _faults_equal(a.round_faults(e, wire, up), b.round_faults(e, wire, up))
        sched = rng.uniform(size=9) < 0.7
        assert faults.incident_events(a.round_faults(e, wire, up), sched) \
            == jfaults.incident_events(b.round_faults(e, wire, up), sched)
    for s in (0, 1, 4, 9):
        assert a.quorum_floor(s) == b.quorum_floor(s)


def test_scripted_faults_equal_jax_package():
    kw = dict(crashes={(0, 2): 0.3, (1, 0): True},
              chunk_retries={(0, 1): 3, (2, 2): 1}, aborts={(1, 1): 777.0},
              corrupt={(0, 0): "nan", (2, 1): "bitflip"})
    a, b = sim.ScriptedFaults(**kw), jsim.ScriptedFaults(**kw)
    wire, up = np.full(3, 4e4), np.array([1e3, 2e3, 3e3])
    for e in range(3):
        _faults_equal(a.round_faults(e, wire, up), b.round_faults(e, wire, up))
    with pytest.raises(ValueError, match="corrupt kind"):
        sim.ScriptedFaults(corrupt={(0, 0): "zap"})


def test_outage_draws_equal_jax_package():
    inner = dict(crash_rate=0.1, loss_rate=0.2, corrupt_rate=0.1, seed=3)
    a = sim.CellOutageModel(12, sim.OutageConfig(cells=3, p_out=0.4,
                                                 p_back=0.3, seed=5),
                            inner=sim.RandomFaults(**inner))
    b = jsim.CellOutageModel(12, jsim.OutageConfig(cells=3, p_out=0.4,
                                                   p_back=0.3, seed=5),
                             inner=jsim.RandomFaults(**inner))
    wire, up = np.full(12, 3e4), np.linspace(1e3, 4e3, 12)
    for e in (0, 4, 1, 2, 3, 7):
        _faults_equal(a.round_faults(e, wire, up), b.round_faults(e, wire, up))
        np.testing.assert_array_equal(a.outage_mask(e), b.outage_mask(e))
        np.testing.assert_array_equal(a.down_cells(e), b.down_cells(e))
    inert = sim.CellOutageModel(4, sim.OutageConfig())
    assert not inert.active and inert.outage_mask(3) is None
    with pytest.raises(ValueError, match="assignment"):
        sim.CellOutageModel(4, sim.OutageConfig(cells=2),
                            assignment=[0, 1, 2, 0])


@pytest.mark.parametrize("kind", ["nan", "inf", "bitflip"])
def test_corrupt_pytree_equals_jax_package_bits(kind):
    row = np_params(3)
    got = faults.corrupt_pytree(t_params(row), kind,
                                faults.corruption_rng(7, 2, 4))
    want = jfaults.corrupt_pytree(j_params(row), kind,
                                  jfaults.corruption_rng(7, 2, 4))
    for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g.view(np.uint32),
                                      np.asarray(w).view(np.uint32))
    # the row itself is untouched (the corruption is on a host copy)
    assert trees_equal(t_params(row), t_params(np_params(3)))
    # bf16 rows take a NaN write at the JAX package's positions
    bf = tree.tree_map(lambda x: x.to(torch.bfloat16), t_params(row))
    out = faults.corrupt_pytree(bf, "nan", faults.corruption_rng(1, 0, 0))
    assert all(np.isnan(l).sum() == max(1, l.size // 64)
               for l in tree.leaves(out))


# --- the deadline prefix and the engine step's fault inputs ------------------

def test_truncate_masks_to_prefix_equals_jax_package():
    rng = np.random.default_rng(0)
    sentinel = np.iinfo(np.int32).max
    masks = {"w": (rng.uniform(size=(5, 1, 37)) < 0.6).astype(np.float32),
             "b": (rng.uniform(size=(5, 37)) < 0.6).astype(np.float32),
             "c": (rng.uniform(size=(5, 3, 1, 1)) < 0.6).astype(np.float32),
             "s": np.ones(5, np.float32)}
    counts = [np.array([0, 3, 37, sentinel, 12], np.int32),
              np.array([1, sentinel, 5, 0, 40], np.int32),
              np.array([0, 1, 2, 3, sentinel], np.int32),
              np.array([0, 1, 2, 0, sentinel], np.int32)]
    got = aggregation.truncate_masks_to_prefix(
        t_params(masks), [torch.from_numpy(c) for c in counts])
    want = jagg.truncate_masks_to_prefix(
        j_params(masks), tuple(jnp.asarray(c) for c in counts))
    for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # host counts work too, and the hand-checked case of the JAX tests
    m = torch.tensor([[[1.0, 0.0, 1.0, 1.0]], [[1.0, 1.0, 0.0, 1.0]]])
    out = aggregation.truncate_masks_to_prefix(
        {"w": m}, (np.array([2, sentinel], np.int32),))
    np.testing.assert_array_equal(
        out["w"].numpy(), [[[1.0, 0.0, 1.0, 0.0]], [[1.0, 1.0, 0.0, 1.0]]])
    with pytest.raises(ValueError, match="mismatch"):
        aggregation.truncate_masks_to_prefix({"w": m}, ())


def _poison(stacked, masks, row, kind, dropped=True):
    """A copy of ``stacked`` whose ``row`` has a NaN / Inf / all-ones
    exponent (bitflip) in each leaf at one element of a kept channel and,
    with ``dropped``, one of a dropped channel (``masks``: the channel
    masks)."""
    out = {}
    for k, sub in stacked.items():
        out[k] = {}
        for n, v in sub.items():
            v = np.array(v)
            r = v[row]
            m = np.broadcast_to(masks[k][n][row], r.shape).reshape(-1)
            flat = r.reshape(-1).copy()
            pos = [np.flatnonzero(m == 1)[:1]]
            if dropped:
                pos.append(np.flatnonzero(m == 0)[:1])
            for p in pos:
                if kind == "bitflip":
                    flat.view(np.uint32)[p] |= np.uint32(0x7F800000)
                else:
                    flat[p] = np.nan if kind == "nan" else -np.inf
            v[row] = flat.reshape(r.shape)
            out[k][n] = v
    return out


def _step_inputs(n=5):
    rng = np.random.default_rng(2)
    old = {"fc0": {"w": rng.normal(size=(n, 20, 12)).astype(np.float32),
                   "b": rng.normal(size=(n, 12)).astype(np.float32)},
           "fc1": {"w": rng.normal(size=(n, 12, 5)).astype(np.float32),
                   "b": rng.normal(size=(n, 5)).astype(np.float32)}}
    new = {k: {m: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
               for m, v in sub.items()} for k, sub in old.items()}
    glob = {k: {m: v[0] for m, v in sub.items()} for k, sub in old.items()}
    d = np.array([0.0, 0.3, 0.5, 0.2, 0.6])
    key = np.asarray(jax.random.PRNGKey(5))
    masks, _ = selection.build_masks_batched(
        t_params(old), t_params(new), torch.tensor(d, dtype=torch.float32),
        config=selection.SelectionConfig(), rng=key)
    return old, new, glob, d, key, tree.tree_map(lambda m: m.numpy(), masks)


@pytest.mark.parametrize("kind", ["nan", "inf", "bitflip"])
@pytest.mark.parametrize("poisoned_weight", [0.0, 7.0])
@pytest.mark.parametrize("cut", [False, True])
def test_step_with_upload_and_delivered_matches_jax_package(
        kind, poisoned_weight, cut):
    """A corrupted row the screen let through (non-finite values at a
    kept and at a dropped channel, with weight 0 and > 0), with and
    without delivered prefixes: the JAX engine's densities exactly, its
    Eq. (4) to 3e-5 with NaNs at the same places, and Eq. (5) from the
    clean values and full masks.

    Eq. (4) computes ``W * M * w``, so a kept non-finite value poisons
    the aggregate even at weight 0 (NaN * 0).  A non-finite value on a
    DROPPED channel adds nothing where the JAX engine's compiled graph
    turns ``W * mask`` into a select — the 1-D leaves, with masks straight
    from the top-k compare (no ``delivered``) — and the port's step skips
    it there too (``sparse_agg``'s select flag); with ``delivered`` the
    cut masks are a product and both packages propagate it.  A sim run
    never reaches either case with the default screen: a row holding any
    non-finite value is quarantined."""
    old, new, glob, d, key, masks = _step_inputs()
    n = d.shape[0]
    upload = _poison(new, masks, 3, kind, dropped=True)
    w = np.array([3.0, 5.0, 2.0, poisoned_weight, 4.0])
    sentinel = np.iinfo(np.int32).max
    delivered = None
    if cut:
        delivered = [
            np.array([sentinel, 2, sentinel, sentinel, 0], np.int32),
            np.array([sentinel, 3, sentinel, 1, 0], np.int32),
            np.array([sentinel, 1, sentinel, sentinel, 2], np.int32),
            np.array([sentinel, 0, sentinel, 2, 1], np.int32)]
    eng = round_engine.BatchedRoundEngine(selection.SelectionConfig())
    got = eng.step(t_params(old), t_params(new), t_params(glob), d, w, key,
                   full_round=False, stacked_upload=t_params(upload),
                   delivered=None if delivered is None else
                   [torch.from_numpy(c) for c in delivered])
    jeng = jre.BatchedRoundEngine(jsel.SelectionConfig())
    want = jeng.step(j_params(old), j_params(new), j_params(glob), d, w,
                     jnp.asarray(key), full_round=False,
                     stacked_upload=j_params(upload),
                     delivered=None if delivered is None else
                     tuple(jnp.asarray(c) for c in delivered))
    assert got.densities.shape == (n,)
    np.testing.assert_array_equal(got.densities.numpy(),
                                  np.asarray(want.densities))
    for g, wnt in zip(tree.leaves(got.global_params),
                      jax.tree_util.tree_leaves(want.global_params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=3e-5,
                                   atol=3e-5, equal_nan=True)
    bad = sum(int((~np.isfinite(g.numpy())).sum())
              for g in tree.leaves(got.global_params))
    assert bad >= (1 if kind == "nan" or poisoned_weight == 0.0 else 0)
    # Eq. (5) from the clean values and the full masks: finite where the
    # global is, the JAX engine's to 3e-5
    gl = [np.isfinite(g.numpy()) for g in tree.leaves(got.global_params)]
    for g, wnt, fin in zip(tree.leaves(got.client_params),
                           jax.tree_util.tree_leaves(want.client_params),
                           gl):
        np.testing.assert_allclose(g.numpy()[:, fin],
                                   np.asarray(wnt)[:, fin], rtol=3e-5,
                                   atol=3e-5)


def _poison_row(stacked, row, value):
    """A copy of ``stacked`` with ``value`` at one element of every leaf
    of client ``row``."""
    out = tree.tree_map(np.array, stacked)
    for leaf in tree.leaves(out):
        leaf[row].reshape(-1)[leaf[row].size // 2] = value
    return out


def _non_finite_match(got, want):
    """Equal non-finite positions, 3e-5 elsewhere; returns the number of
    non-finite elements per leaf."""
    bad = []
    for g, wnt in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
        g, wnt = g.numpy(), np.asarray(wnt)
        np.testing.assert_array_equal(~np.isfinite(g), ~np.isfinite(wnt))
        np.testing.assert_allclose(g, wnt, rtol=3e-5, atol=3e-5,
                                   equal_nan=True)
        bad.append(int((~np.isfinite(g)).sum()))
    return bad


@pytest.mark.parametrize("kind", ["nan", "inf"])
@pytest.mark.parametrize("route", ["stacked_new", "stacked_upload"])
def test_step_non_finite_on_dropped_channel_matches_jax_engine(kind, route):
    """C5: client 3 keeps no channel (D = 1) and holds a NaN / Inf in
    every leaf, so each sits on a dropped channel.  The JAX engine's
    compiled step skips it at the 1-D leaves (a select) and lets it
    through at the rank-2 ones (their channel mask is broadcast); the
    port's step, with no ``delivered``, gives the same non-finite
    positions and the same Eq. (4) to 3e-5 elsewhere."""
    old, new, glob, d, key, _ = _step_inputs()
    d = d.copy()
    d[3] = 1.0
    w = np.array([3.0, 5.0, 2.0, 4.0, 1.0])
    value = np.nan if kind == "nan" else np.inf
    bad_row = _poison_row(new, 3, value)
    kw_t, kw_j = {}, {}
    if route == "stacked_new":
        new_t, new_j = t_params(bad_row), j_params(bad_row)
    else:
        new_t, new_j = t_params(new), j_params(new)
        kw_t = dict(stacked_upload=t_params(bad_row))
        kw_j = dict(stacked_upload=j_params(bad_row))
    got = round_engine.BatchedRoundEngine(selection.SelectionConfig()).step(
        t_params(old), new_t, t_params(glob), d, w, key, full_round=False,
        **kw_t)
    want = jre.BatchedRoundEngine(jsel.SelectionConfig()).step(
        j_params(old), new_j, j_params(glob), d, w, jnp.asarray(key),
        full_round=False, **kw_j)
    np.testing.assert_array_equal(got.densities.numpy(),
                                  np.asarray(want.densities))
    bad = _non_finite_match(got.global_params, want.global_params)
    shapes = [l.shape for l in tree.leaves(glob)]
    assert [b > 0 for b in bad] == [len(s) > 1 for s in shapes], bad


def test_run_sim_corrupt_row_unscreened_matches_jax_package():
    """C5 through the public simulator: sync, 6 clients, A_server 0.3, 2
    rounds, every client's round-2 upload corrupted with NaNs and the
    validation screen off.  In round 2 the clients drop channels, so the
    NaNs on dropped bias channels stay out of the JAX package's global
    (its compiled step) and out of the port's: equal non-finite positions
    and 3e-5 elsewhere, for every corrupted client."""
    n = 6
    for c in range(n):
        vkw = dict(screen_nonfinite=False, norm_factor=0.0)
        kw = dict(rounds=2, a_server=0.3, seed=0)
        want = jsim.run_sim(
            "feddd", j_params(np_params()), telemetry(n, jax_side=True),
            ltf_jax, None, sim=jsim.SimConfig(policy="sync"),
            faults=jsim.ScriptedFaults(
                corrupt={(1, c): "nan"},
                validation=jsim.ValidationConfig(**vkw)), **kw)
        got = sim.run_sim(
            "feddd", t_params(np_params()), telemetry(n), ltf_torch, None,
            sim=sim.SimConfig(policy="sync"),
            faults=sim.ScriptedFaults(
                corrupt={(1, c): "nan"},
                validation=sim.ValidationConfig(**vkw)),
            device="cpu", **kw)
        _non_finite_match(got.global_params, want.global_params)


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_eq4_non_finite_on_dropped_channel_propagates_as_jax_eager(kind):
    """The literal Eq. (4), ``W * M * w``: a NaN / Inf on a masked-out
    channel poisons the aggregate, as in the JAX package's eager
    ``aggregate_sparse_stacked``."""
    old, new, glob, d, key, masks = _step_inputs()
    upload = _poison(new, masks, 3, kind)
    w = np.array([3.0, 5.0, 2.0, 0.0, 4.0])
    got = aggregation.aggregate_sparse_stacked(
        t_params(upload), t_params(masks), w, prev_global=t_params(glob))
    want = jagg.aggregate_sparse_stacked(
        j_params(upload), j_params(masks), jnp.asarray(w, jnp.float32),
        prev_global=j_params(glob))
    for g, wnt in zip(tree.leaves(got),
                      jax.tree_util.tree_leaves(want)):
        assert (~np.isfinite(g.numpy())).sum() == 2
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=3e-5,
                                   atol=3e-5, equal_nan=True)


def test_step_without_fault_inputs_is_unchanged():
    """``stacked_upload=None, delivered=None`` issue exactly a fault-free
    step: the same outputs bit for bit, and an upload equal to
    ``stacked_new`` with all-arrived counts changes nothing either."""
    n = 4
    rng = np.random.default_rng(3)
    old = {"w": rng.normal(size=(n, 8, 6)).astype(np.float32)}
    new = {"w": (old["w"] + rng.normal(0, 0.1, old["w"].shape))
           .astype(np.float32)}
    glob = {"w": old["w"][0]}
    args = (t_params(old), t_params(new), t_params(glob),
            np.array([0.0, 0.4, 0.5, 0.2]), np.array([1.0, 2.0, 3.0, 4.0]),
            np.asarray(jax.random.PRNGKey(1)))
    eng = round_engine.BatchedRoundEngine()
    a = eng.step(*args, full_round=False)
    b = eng.step(*args, full_round=False, stacked_upload=None,
                 delivered=None)
    c = eng.step(*args, full_round=False, stacked_upload=t_params(new),
                 delivered=[np.full(n, np.iinfo(np.int32).max, np.int32)])
    for x, y, z in zip(tree.leaves(a), tree.leaves(b), tree.leaves(c)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y) and torch.equal(x, z)


# --- the validation screen ----------------------------------------------------

def test_screen_quarantine_equals_jax_package():
    rng = np.random.default_rng(4)
    for trial in range(20):
        n = int(rng.integers(1, 9))
        norms = rng.lognormal(0.0, 2.0, n)
        finite = rng.uniform(size=n) < 0.8
        cand = rng.uniform(size=n) < 0.8
        for vcfg in (sim.ValidationConfig(),
                     sim.ValidationConfig(norm_factor=2.0, min_reference=1),
                     sim.ValidationConfig(screen_nonfinite=False),
                     sim.ValidationConfig(norm_factor=0.0)):
            jv = jsim.ValidationConfig(**vars(vcfg))
            np.testing.assert_array_equal(
                faults.screen_quarantine(norms, finite, cand, vcfg),
                jfaults.screen_quarantine(norms, finite, cand, jv))
    vcfg = sim.ValidationConfig(min_reference=1, norm_factor=2.0)
    assert not faults.screen_quarantine(
        np.array([1.0, 1e12]), np.array([True, True]),
        np.array([True, True]), vcfg).any()
    assert faults.screen_quarantine(
        np.array([1.0, 1.1, 1e12]), np.ones(3, bool), np.ones(3, bool),
        vcfg).tolist() == [False, False, True]


def test_update_stats_equal_jax_package():
    rng = np.random.default_rng(5)
    old = {"a": rng.normal(size=(6, 30, 7)).astype(np.float32),
           "b": rng.normal(size=(6, 7)).astype(np.float32),
           "s": rng.normal(size=6).astype(np.float32)}
    new = {k: (v + rng.normal(0, 0.5, v.shape)).astype(np.float32)
           for k, v in old.items()}
    new["a"][2, 3, 1] = np.nan
    new["b"][4, 0] = np.inf
    got_n, got_f = faults.update_stats_stacked(t_params(new), t_params(old))
    want_n, want_f = jfaults.update_stats_stacked(j_params(new),
                                                  j_params(old))
    np.testing.assert_array_equal(got_f, want_f)
    assert got_f.tolist() == [True, True, False, True, False, True]
    fin = np.isfinite(want_n)
    np.testing.assert_allclose(got_n[fin], want_n[fin], rtol=1e-6)
    got_f[0] = False                     # writable copies
    row_n = {k: v[1] for k, v in new.items()}
    row_o = {k: v[1] for k, v in old.items()}
    assert faults.host_update_stats(t_params(row_n), t_params(row_o)) == \
        jfaults.host_update_stats(j_params(row_n), j_params(row_o))


# --- runs against the JAX package ---------------------------------------------

@pytest.mark.parametrize("policy", ["sync", "partial", "retry", "async"])
def test_faulty_markov_run_matches_jax_package(policy):
    n = 8
    corrupt = 0.0 if policy == "async" else 0.2
    fkw = dict(crash_rate=0.15, loss_rate=0.3, corrupt_rate=corrupt,
               corrupt_kind="mix", quorum=0.25, max_retries=2, seed=3)
    kw = dict(rounds=4, a_server=0.6, h=3, seed=0)
    pol = {"partial": lambda m: m.DeadlinePolicy(partial=True)}.get(
        policy, lambda m: policy)

    def net(mod, tel):
        return mod.MarkovFadingNetwork(tel, p_fade=0.25, p_recover=0.5,
                                       fade_factor=0.1, seed=1)

    want = jsim.run_sim("feddd", j_params(np_params()),
                        telemetry(n, jax_side=True), ltf_jax, None,
                        sim=jsim.SimConfig(policy=pol(jsim)),
                        network=net(jsim, telemetry(n, jax_side=True)),
                        faults=jsim.RandomFaults(**fkw), **kw)
    got = sim.run_sim("feddd", t_params(np_params()), telemetry(n),
                      ltf_torch, None, sim=sim.SimConfig(policy=pol(sim)),
                      network=net(sim, telemetry(n)),
                      faults=sim.RandomFaults(**fkw), device="cpu", **kw)
    assert [(k, c) for _, k, c in got.event_trace] == \
        [(k, c) for _, k, c in want.event_trace]
    np.testing.assert_allclose([e[0] for e in got.event_trace],
                               [e[0] for e in want.event_trace], rtol=1e-6)
    for g, w in zip(got.history, want.history):
        assert (g.participants, g.survivors, g.retries, g.skipped) == \
            (w.participants, w.survivors, w.retries, w.skipped)
        np.testing.assert_allclose(g.sim_time, w.sim_time, rtol=1e-6)
        np.testing.assert_allclose(
            [g.abandoned_bytes, g.quarantined_bytes, g.wire_bytes],
            [w.abandoned_bytes, w.quarantined_bytes, w.wire_bytes],
            rtol=1e-6)
        np.testing.assert_array_equal(g.dropout_rates, w.dropout_rates)
    assert_close_to_jax(got.global_params, want.global_params, atol=1e-5)


# --- the JAX package's hand-computed and transparency cases ------------------

@pytest.mark.parametrize("policy", ["sync", "deadline", "retry", "async"])
def test_zero_rate_faults_bit_identical_to_fault_free(policy):
    n = 6
    kw = dict(rounds=4, a_server=0.6, h=3, seed=0, device="cpu",
              sim=sim.SimConfig(policy=policy))
    ref = sim.run_sim("feddd", t_params(np_params()), telemetry(n),
                      ltf_torch, None, **kw)
    got = sim.run_sim("feddd", t_params(np_params()), telemetry(n),
                      ltf_torch, None, faults=sim.RandomFaults(), **kw)
    assert ref.event_trace == got.event_trace
    for rr, rg in zip(ref.history, got.history):
        assert (rr.sim_time, rr.participants, rr.mean_loss, rr.wire_bytes) \
            == (rg.sim_time, rg.participants, rg.mean_loss, rg.wire_bytes)
        np.testing.assert_array_equal(rr.dropout_rates, rg.dropout_rates)
        assert not rg.skipped and rg.retries == 0
        assert rg.abandoned_bytes == rg.quarantined_bytes == 0.0
    assert trees_equal(ref.global_params, got.global_params)


def test_zero_rate_faults_route_and_match_protocol():
    n = 5
    kw = dict(rounds=3, a_server=0.6, h=2, seed=0, device="cpu")
    ref = protocol.run_scheme("feddd", t_params(np_params(1)),
                              telemetry(n, 2), ltf_torch, None, **kw)
    got = protocol.run_scheme("feddd", t_params(np_params(1)),
                              telemetry(n, 2), ltf_torch, None,
                              faults=sim.RandomFaults(), **kw)
    assert isinstance(got, sim.SimResult)
    for rr, rg in zip(ref.history, got.history):
        assert rr.sim_time == rg.sim_time
    assert trees_equal(ref.global_params, got.global_params)


def test_scripted_crash_hand_computed_survivor_aggregate_and_clock():
    """One scripted crash in a sync+static round 1 (D^1 = 0, all-ones
    masks): the global equals the survivor Eq. (4) weighted mean written
    out in float32 in the plain version's order, and the clock the max
    over survivors of Eq. (12) — both exactly."""
    n = 3
    tel = telemetry(n)
    res = sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch, None,
                      sim=sim.SimConfig(policy="sync"),
                      faults=sim.ScriptedFaults(crashes={(0, 2): 0.5}),
                      rounds=1, a_server=0.6, h=5, seed=0, device="cpu")
    rec = res.history[0]
    assert (rec.participants, rec.survivors, rec.skipped) == (2, 2, False)
    from repro_torch import prng
    _, rk = prng.split(prng.PRNGKey(0))
    news = [ltf_torch(t_params(np_params()), i, prng.fold_in(rk, i))[0]
            for i in range(n)]
    w = np.asarray(tel.num_samples, np.float32).copy()
    w[2] = 0.0
    for li, g in enumerate(tree.leaves(res.global_params)):
        x = [tree.leaves(p)[li].numpy() for p in news]
        num = (x[0] * w[0] + x[1] * w[1]) + x[2] * w[2]
        den = (np.float32(w[0]) + w[1]) + w[2]
        np.testing.assert_array_equal(g.numpy(),
                                      num / np.maximum(den, 1e-12))
    ti = baselines.round_times(tel, np.zeros(n))
    assert rec.sim_time == float(max(ti[0], ti[1]))


def test_scripted_retransmits_exact_bytes_and_delay():
    n, k = 3, 3
    tel = telemetry(n)
    kw = dict(rounds=1, a_server=0.6, h=5, seed=0, device="cpu",
              sim=sim.SimConfig(policy="sync"))
    base = sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch, None,
                       **kw)
    fc = sim.FaultConfig()
    res = sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch, None,
                      faults=sim.ScriptedFaults(chunk_retries={(0, 0): k},
                                                config=fc), **kw)
    rec, ref = res.history[0], base.history[0]
    assert rec.retries == k
    assert rec.wire_bytes == ref.wire_bytes + k * fc.chunk_bytes
    ti = baselines.round_times(tel, np.zeros(n))
    delay = (k * fc.chunk_bytes / float(tel.uplink_rate[0])
             + fc.backoff_base * (2.0 ** k - 1.0))
    assert rec.sim_time == float(max(ti[0] + delay, ti[1], ti[2]))
    assert trees_equal(base.global_params, res.global_params)


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_corrupted_payload_quarantined_equals_crash(kind):
    n = 5
    tel = telemetry(n)
    kw = dict(rounds=1, a_server=0.6, h=5, seed=0, device="cpu",
              sim=sim.SimConfig(policy="sync"))
    corrupted = sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch,
                            None, faults=sim.ScriptedFaults(
                                corrupt={(0, 0): kind}), **kw)
    crashed = sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch,
                          None, faults=sim.ScriptedFaults(
                              crashes={(0, 0): 0.5}), **kw)
    rec = corrupted.history[0]
    assert rec.participants == n - 1
    assert rec.quarantined_bytes == float(tel.model_bytes[0])
    assert crashed.history[0].quarantined_bytes == 0.0
    assert trees_equal(corrupted.global_params, crashed.global_params)


def test_quorum_miss_skips_round_and_holds_global():
    n = 4
    res = sim.run_sim("feddd", t_params(np_params()), telemetry(n),
                      ltf_torch, None, sim=sim.SimConfig(policy="sync"),
                      faults=sim.ScriptedFaults(
                          crashes={(0, 0): 0.5, (0, 1): 0.5, (0, 2): 0.5},
                          config=sim.FaultConfig(quorum=2)),
                      rounds=1, a_server=0.6, h=5, seed=0, device="cpu")
    rec = res.history[0]
    assert rec.skipped and rec.participants == 0 and rec.survivors == 1
    assert trees_equal(res.global_params, t_params(np_params()))


def test_fault_guards_reject_unsupported_combinations():
    n = 4
    base = dict(rounds=1, device="cpu")
    with pytest.raises(ValueError, match="wave-policy only"):
        sim.run_sim("feddd", t_params(np_params()), telemetry(n), ltf_torch,
                    None, sim=sim.SimConfig(policy="async"),
                    faults=sim.RandomFaults(corrupt_rate=0.1), **base)
    from torch_sim_parity import np_sub_params, nbytes
    clients = [t_params(np_sub_params(i, (12, 8)[i % 2])) for i in range(n)]
    tel = telemetry(n, 0, [nbytes(np_sub_params(i, (12, 8)[i % 2]))
                           for i in range(n)])
    with pytest.raises(ValueError, match="homogeneous stacked"):
        sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch, None,
                    client_params=clients,
                    faults=sim.RandomFaults(corrupt_rate=0.1), **base)
    with pytest.raises(ValueError, match="homogeneous stacked"):
        sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch, None,
                    client_params=clients,
                    sim=sim.SimConfig(policy=sim.DeadlinePolicy(
                        partial=True)), **base)
    # a client mesh keeps rows on their shard: no row corruption, no
    # delivered prefixes (the JAX package's guards)
    with pytest.raises(ValueError, match="payload corruption"):
        sim.run_sim("feddd", t_params(np_params()), telemetry(n), ltf_torch,
                    None, mesh=1, faults=sim.RandomFaults(corrupt_rate=0.1),
                    **base)
    with pytest.raises(ValueError, match="partial aggregation"):
        sim.run_sim("feddd", t_params(np_params()), telemetry(n), ltf_torch,
                    None, mesh=1, sim=sim.SimConfig(
                        policy=sim.DeadlinePolicy(partial=True)), **base)


def test_ragged_fleet_crash_faults_match_jax_package():
    """A ragged fleet takes crash / loss faults on the grouped wave fleet
    (the screen's norms one transfer for every group)."""
    from torch_sim_parity import np_sub_params, nbytes
    n, widths = 6, (12, 8, 5)
    subs = [np_sub_params(100 + i, widths[i % 3]) for i in range(n)]
    mb = [nbytes(c) for c in subs]
    fkw = dict(crash_rate=0.2, loss_rate=0.3, quorum=0.5, seed=4)
    kw = dict(rounds=3, a_server=0.6, h=2, seed=0)
    want = jsim.run_sim("feddd", j_params(np_params()),
                        telemetry(n, 1, mb, jax_side=True), ltf_jax, None,
                        client_params=[j_params(c) for c in subs],
                        faults=jsim.RandomFaults(**fkw), **kw)
    got = sim.run_sim("feddd", t_params(np_params()), telemetry(n, 1, mb),
                      ltf_torch, None,
                      client_params=[t_params(c) for c in subs],
                      faults=sim.RandomFaults(**fkw), device="cpu", **kw)
    assert [(k, c) for _, k, c in got.event_trace] == \
        [(k, c) for _, k, c in want.event_trace]
    for g, w in zip(got.history, want.history):
        assert (g.participants, g.survivors, g.skipped) == \
            (w.participants, w.survivors, w.skipped)
        np.testing.assert_allclose(g.sim_time, w.sim_time, rtol=1e-6)
    assert_close_to_jax(got.global_params, want.global_params, atol=1e-5)


def test_async_crash_and_abort_faults_complete_with_accounting(tmp_path):
    import json
    from repro_torch.obs import ObsConfig
    n = 5
    path = tmp_path / "async.jsonl"

    def go(jsonl=None):
        kw = dict(sim=sim.SimConfig(policy=sim.AsyncPolicy(buffer_size=2)),
                  rounds=5, a_server=0.6, h=2, seed=0, device="cpu",
                  faults=sim.RandomFaults(crash_rate=0.25, loss_rate=0.25,
                                          max_retries=1, seed=11))
        if jsonl is not None:
            kw["obs"] = ObsConfig(enabled=True, jsonl_path=str(jsonl))
        return sim.run_sim("feddd", t_params(np_params()), telemetry(n),
                           ltf_torch, None, **kw)

    res = go(path)
    assert len(res.history) == 5
    assert all(r.participants == 2 for r in res.history)
    kinds = {json.loads(line).get("kind")
             for line in path.read_text().splitlines()
             if json.loads(line).get("event") == "fault"}
    assert kinds & {"crash", "abort"}
    again = go()
    assert trees_equal(res.global_params, again.global_params)
    assert [(r.sim_time, r.retries, r.abandoned_bytes)
            for r in res.history] == \
        [(r.sim_time, r.retries, r.abandoned_bytes) for r in again.history]


# --- determinism across processes ---------------------------------------------

_DIGEST_SNIPPET = r"""
import hashlib, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
torch.set_num_threads(1)
from repro_torch import sim, tree
from torch_sim_parity import ltf_torch, np_params, t_params, telemetry

h = hashlib.sha256()
for policy in ("sync", "deadline", "retry"):
    t = telemetry(5)
    net = sim.MarkovFadingNetwork(t, p_fade=0.3, p_recover=0.4,
                                  fade_factor=0.05, seed=7)
    res = sim.run_sim("feddd", t_params(np_params()), t, ltf_torch, None,
                      sim=sim.SimConfig(policy=policy), network=net,
                      faults=sim.RandomFaults(crash_rate=0.2, loss_rate=0.15,
                                              corrupt_rate=0.15, seed=5),
                      rounds=4, a_server=0.6, h=2, seed=0, device="cpu")
    h.update(np.asarray([e[0] for e in res.event_trace]).tobytes())
    h.update(",".join(f"{e[1]}:{e[2]}" for e in res.event_trace).encode())
    h.update(np.asarray([[r.sim_time, r.participants, r.survivors,
                          r.retries, r.abandoned_bytes, r.quarantined_bytes,
                          float(r.skipped)] for r in res.history]).tobytes())
    for leaf in tree.leaves(res.global_params):
        h.update(leaf.numpy().tobytes())
print(h.hexdigest())
"""


def test_faulty_run_deterministic_across_processes():
    root = Path(__file__).resolve().parents[1]
    digests = []
    for _ in range(2):
        out = subprocess.run(
            [sys.executable, "-c", _DIGEST_SNIPPET, str(root / "tests")],
            capture_output=True, text=True, check=False,
            env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin",
                 "JAX_PLATFORMS": "cpu", "HOME": "/tmp"})
        assert out.returncode == 0, out.stderr[-2000:]
        digests.append(out.stdout.strip())
    assert digests[0] == digests[1] and len(digests[0]) == 64
