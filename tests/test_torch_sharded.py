"""The client-sharded mesh of the port (``repro_torch.launch.mesh``,
``ShardedRoundEngine``, ``GroupedRoundEngine(mesh=)``, the protocol's and
the simulator's ``mesh=`` routing) against the JAX package and against
the port's single-device engines, on the CPU.

A ``ClientMesh`` that repeats the CPU device is a mesh of virtual shards:
the whole multi-shard step (padding, per-shard partials, the compacted
collective and its overflow) runs in this process.  Contracts, as the
JAX package's ``tests/test_sharded_engine.py``:

* the mesh helpers clamp to the visible devices and to divisors;
* one shard equals the port's ``BatchedRoundEngine`` bit for bit (and
  the JAX package's one-device ``ShardedRoundEngine`` within the engine
  tolerances); the protocol and the simulator with ``mesh=1`` equal their
  runs without a mesh bit for bit;
* 13 clients over 8 shards (pad 3) are within 2e-6 of the JAX package's
  single-device engine with equal densities, for the dense sum, the
  sparse collective at keep 1.0 and at keep 0.8 with D = 0.75 (overflow
  0); zero dropout at keep 0.8 overflows;
* the JAX package's ``ShardedRoundEngine`` on 4 CPU devices (one
  subprocess) and the port's 4 virtual shards agree: densities exactly,
  params to 2e-6, ``collective_overflow`` equal;
* the reference's rejections raise the reference's errors.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import round_engine as jre
from repro.core import selection as jsel
from repro.launch import mesh as jmesh
from repro_torch import tree
from repro_torch.comm import CommConfig
from repro_torch.comm.payload import WireSpec, account_collective
from repro_torch.core import round_engine, selection
from repro_torch.core import coverage as cov_mod
from repro_torch.core.protocol import FedDDServer, ProtocolConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import ClientMesh

from torch_sim_parity import ltf_torch, np_params, np_sub_params, t_params
from torch_sim_parity import nbytes, telemetry

SRC = str(Path(__file__).resolve().parents[1] / "src")
CPU = torch.device("cpu")


def _virtual(p):
    return ClientMesh((CPU,) * p)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fleet_np(n=13, seed=0):
    """The JAX package's sharded-test fleet, drawn with numpy: w (4, 8),
    b (8,), client i scaled by 1 + 0.01 i, the update x 1.01 + 0.002."""
    rng = np.random.default_rng(seed)
    g = {"w": rng.normal(size=(4, 8)).astype(np.float32),
         "b": rng.normal(size=(8,)).astype(np.float32)}
    old = {k: np.stack([v * np.float32(1 + 0.01 * i) for i in range(n)])
           for k, v in g.items()}
    new = {k: (v * np.float32(1.01) + np.float32(0.002)).astype(np.float32)
           for k, v in old.items()}
    w = np.arange(1, n + 1, dtype=np.float32)
    return g, old, new, w


def _t(x):
    return tree.tree_map(lambda a: torch.from_numpy(np.array(a)), x)


def _j(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _close_to_jax(got, want, tol=2e-6):
    gl, wl = tree.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


# --- the mesh helpers --------------------------------------------------------

def test_mesh_helpers_clamp_and_resolve():
    m = mesh_mod.make_client_mesh(device="cpu")
    assert m.axis_names == ("clients",) and m.num_shards == 1
    assert mesh_mod.make_client_mesh(8, device="cpu").num_shards == 1
    assert mesh_mod.resolve_client_mesh(True, "cpu").num_shards == 1
    assert mesh_mod.resolve_client_mesh(3, "cpu").devices == (CPU,)
    v = _virtual(4)
    assert mesh_mod.resolve_client_mesh(v) is v
    assert v.num_shards == 4
    with pytest.raises(ValueError, match="clients"):
        mesh_mod.resolve_client_mesh(ClientMesh((CPU,), ("pod",)))
    with pytest.raises(TypeError):
        mesh_mod.resolve_client_mesh("clients")
    with pytest.raises(ValueError):
        ClientMesh(())
    grid = mesh_mod.make_host_mesh(data=3, model=1, device="cpu")
    assert grid.axis_sizes == (1, 1) and grid.devices == (CPU,)
    assert [mesh_mod._largest_divisor_leq(6, k) for k in (4, 6, 9, 0)] == \
        [3, 6, 6, 1]
    # the CPU mesh of the JAX package clamps the same way
    assert jmesh.make_client_mesh(8).devices.size == m.num_shards


# --- the engine step ---------------------------------------------------------

STEP_KINDS = [(False, False), (True, False), (False, True)]


@pytest.mark.parametrize("full_round,dense", STEP_KINDS)
def test_one_shard_bit_equal_to_engine_and_close_to_jax(full_round, dense):
    g, old, new, w = _fleet_np(10)
    d = np.linspace(0.0, 0.6, 10).astype(np.float32)
    rk = np.asarray(jax.random.PRNGKey(3))
    base = round_engine.BatchedRoundEngine()
    shard = round_engine.ShardedRoundEngine(mesh=_virtual(1))
    o1 = base.step(_t(old), _t(new), _t(g), d, w, rk,
                   full_round=full_round, dense_masks=dense)
    o2 = shard.step(_t(old), _t(new), _t(g), d, w, rk,
                    full_round=full_round, dense_masks=dense)
    assert _equal(o1.global_params, o2.global_params)
    assert _equal(o1.client_params, o2.client_params)
    assert torch.equal(o1.densities, o2.densities)
    assert float(o2.collective_overflow) == 0.0
    want = jre.ShardedRoundEngine(
        jsel.SelectionConfig(), mesh=jmesh.make_client_mesh(1)).step(
        _j(old), _j(new), _j(g), jnp.asarray(d), jnp.asarray(w),
        jnp.asarray(rk), full_round=full_round, dense_masks=dense)
    _close_to_jax(o2.global_params, want.global_params, 1e-5)
    _close_to_jax(o2.client_params, want.client_params, 1e-5)
    np.testing.assert_allclose(o2.densities.numpy(),
                               np.asarray(want.densities), rtol=1e-6)


MULTI = [("dense", 1.0, "mixed"), ("sparse", 1.0, "mixed"),
         ("sparse", 0.8, "high"), ("sparse", 0.8, "zero")]


def _dropout(kind, n):
    return {"mixed": np.linspace(0.0, 0.6, n), "high": np.full(n, 0.75),
            "zero": np.zeros(n)}[kind].astype(np.float32)


@pytest.mark.parametrize("collective,keep,drop", MULTI)
def test_eight_virtual_shards_close_to_jax_engine(collective, keep, drop):
    """13 clients over 8 virtual shards (the trailing shards padded):
    within 2e-6 of the JAX package's single-device engine, densities
    exact; at keep 0.8 every client keeps 2 of 8 channels with D = 0.75
    (any shard's union <= 4 <= K = 7: overflow 0), and with D = 0 the
    buffer overflows (the certificate > 0)."""
    n = 13
    g, old, new, w = _fleet_np(n)
    d = _dropout(drop, n)
    rk = np.asarray(jax.random.PRNGKey(3))
    eng = round_engine.ShardedRoundEngine(
        mesh=_virtual(8), collective=collective, keep_fraction=keep)
    got = eng.step(_t(old), _t(new), _t(g), d, w, rk, full_round=False)
    ovf = float(got.collective_overflow)
    if drop == "zero":
        assert ovf > 0.0
        return
    assert ovf == 0.0
    want = jre.BatchedRoundEngine(jsel.SelectionConfig()).step(
        _j(old), _j(new), _j(g), jnp.asarray(d), jnp.asarray(w),
        jnp.asarray(rk), full_round=False)
    _close_to_jax(got.global_params, want.global_params)
    _close_to_jax(got.client_params, want.client_params)
    np.testing.assert_array_equal(got.densities.numpy(),
                                  np.asarray(want.densities))
    # and to the port's own single-device step
    one = round_engine.BatchedRoundEngine().step(
        _t(old), _t(new), _t(g), d, w, rk, full_round=False)
    for a, b in zip(tree.leaves(one.global_params),
                    tree.leaves(got.global_params)):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("variant", ["auto8_random", "trimmed", "clip"])
def test_virtual_shards_wire_format_and_robust_close_to_engine(variant):
    """Global fleet ids on every shard: random masks and int8 stochastic
    rounding draw each client's own stream (masks, densities and wire
    overhead equal the single-device step's); robust Eq. (4) gathers every
    shard's rows (the JAX package's all-gather fallback) and equals it."""
    n = 13
    g, old, new, w = _fleet_np(n, seed=1)
    d = np.linspace(0.0, 0.6, n).astype(np.float32)
    rk = np.asarray(jax.random.PRNGKey(5))
    kw = (dict(selection_cfg=selection.SelectionConfig("random"),
               comm=CommConfig("auto", 8)) if variant == "auto8_random"
          else dict(robust_agg=variant))
    one = round_engine.BatchedRoundEngine(**kw).step(
        _t(old), _t(new), _t(g), d, w, rk, full_round=False)
    got = round_engine.ShardedRoundEngine(mesh=_virtual(4), **kw).step(
        _t(old), _t(new), _t(g), d, w, rk, full_round=False)
    assert torch.equal(one.densities, got.densities)
    if variant == "auto8_random":
        assert torch.equal(one.wire_overhead, got.wire_overhead)
    for a, b in zip(tree.leaves(one.global_params) +
                    tree.leaves(one.client_params),
                    tree.leaves(got.global_params) +
                    tree.leaves(got.client_params)):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_step_non_finite_on_dropped_channel_matches_jax(shards):
    """C5 on the sharded step: client 3 keeps no channel (D = 1) and holds
    a NaN in each leaf.  The JAX package's compiled sharded step skips it
    at the 1-D leaf and lets it through at the rank-2 one, and so do the
    port's one and four shards."""
    n = 10
    g, old, new, w = _fleet_np(n)
    d = np.linspace(0.0, 0.6, n).astype(np.float32)
    d[3] = 1.0
    for leaf in new.values():
        leaf[3].reshape(-1)[1] = np.nan
    rk = np.asarray(jax.random.PRNGKey(3))
    got = round_engine.ShardedRoundEngine(mesh=_virtual(shards)).step(
        _t(old), _t(new), _t(g), d, w, rk, full_round=False)
    want = jre.ShardedRoundEngine(
        jsel.SelectionConfig(), mesh=jmesh.make_client_mesh(1)).step(
        _j(old), _j(new), _j(g), jnp.asarray(d), jnp.asarray(w),
        jnp.asarray(rk), full_round=False)
    for k in ("w", "b"):
        gv, wv = got.global_params[k].numpy(), np.asarray(
            want.global_params[k])
        np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
        np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-5,
                                   equal_nan=True)
    assert np.isfinite(got.global_params["b"].numpy()).all()
    assert not np.isfinite(got.global_params["w"].numpy()).all()


def test_sharded_engine_rejects_overrides_and_bad_config():
    g, old, new, w = _fleet_np(4)
    eng = round_engine.ShardedRoundEngine(mesh=_virtual(2))
    with pytest.raises(NotImplementedError, match="single-device"):
        eng.step(_t(old), _t(new), _t(g), np.zeros(4), w, None,
                 full_round=False, stacked_upload=_t(new))
    with pytest.raises(NotImplementedError, match="single-device"):
        eng.step(_t(old), _t(new), _t(g), np.zeros(4), w, None,
                 full_round=False, delivered=[np.zeros(4, np.int32)] * 2)
    with pytest.raises(ValueError, match="requires a mesh"):
        round_engine.ShardedRoundEngine()
    with pytest.raises(ValueError, match="collective"):
        round_engine.ShardedRoundEngine(mesh=_virtual(1), collective="ring")
    with pytest.raises(ValueError, match="keep_fraction"):
        round_engine.ShardedRoundEngine(mesh=_virtual(1), keep_fraction=0.0)
    with pytest.raises(ValueError, match="clients"):
        round_engine.ShardedRoundEngine(mesh=ClientMesh((CPU,), ("pod",)))


# --- the grouped step on a mesh ----------------------------------------------

def _ragged_np(n=10, seed=0):
    """The JAX package's sharded grouped fleet: w1 (4, 8), b1 (8,); odd
    clients hold the half-width sub-model; client i scaled by 1 + 0.01 i."""
    rng = np.random.default_rng(seed)
    g = {"w1": rng.normal(size=(4, 8)).astype(np.float32),
         "b1": rng.normal(size=(8,)).astype(np.float32)}

    def sub(frac, i):
        return {k: (v[tuple(slice(0, max(1, int(s * frac)))
                            for s in v.shape)] * np.float32(1 + 0.01 * i))
                for k, v in g.items()}
    return g, [sub(1.0 if i % 2 == 0 else 0.5, i) for i in range(n)]


def _grouped_batches(g, clients, drop=0.3):
    from repro.fl.heterogeneity import group_by_shape as j_group
    from repro_torch.fl.heterogeneity import group_by_shape
    full_w = cov_mod.channel_widths(_t(g), -1)
    cw = [cov_mod.channel_widths(_t(p), -1) for p in clients]
    cr = cov_mod.coverage_rates(cw, full_w)
    p_b, j_b = [], []
    for grp in group_by_shape([_t(p) for p in clients]):
        old = {k: np.stack([clients[i][k] for i in grp.indices])
               for k in g}
        new = {k: (v * np.float32(1.01) + np.float32(0.002)).astype(
            np.float32) for k, v in old.items()}
        cov = cov_mod.coverage_pytree(_t(clients[grp.indices[0]]), cr, -1)
        dr = np.full(grp.size, drop, np.float32)
        p_b.append(round_engine.GroupBatch(
            indices=np.asarray(grp.indices, np.int64), stacked_old=_t(old),
            stacked_new=_t(new), coverage=cov, dropout=torch.from_numpy(dr)))
        j_b.append(jre.GroupBatch(
            indices=jnp.asarray(grp.indices, jnp.int32), stacked_old=_j(old),
            stacked_new=_j(new),
            coverage=jax.tree_util.tree_map(
                lambda c: jnp.asarray(c.numpy()), cov),
            dropout=jnp.asarray(dr)))
    assert [list(b.indices) for b in p_b] == [
        list(x.indices) for x in j_group([_j(p) for p in clients])]
    return p_b, j_b


@pytest.mark.parametrize("full_round,dense", STEP_KINDS)
def test_grouped_step_on_eight_virtual_shards_close_to_jax(full_round,
                                                           dense):
    g, clients = _ragged_np()
    p_b, j_b = _grouped_batches(g, clients)
    w = np.arange(1, 11, dtype=np.float32)
    rk = np.asarray(jax.random.PRNGKey(3))
    got = round_engine.GroupedRoundEngine(mesh=_virtual(8)).step(
        p_b, _t(g), w, rk, full_round=full_round, dense_masks=dense)
    want = jre.GroupedRoundEngine(jsel.SelectionConfig()).step(
        j_b, _j(g), jnp.asarray(w), jnp.asarray(rk), full_round=full_round,
        dense_masks=dense)
    _close_to_jax(got.global_params, want.global_params)
    for gg, wg in zip(got.group_client_params, want.group_client_params):
        _close_to_jax(gg, wg)
    np.testing.assert_allclose(got.densities.numpy(),
                               np.asarray(want.densities), rtol=1.2e-7)
    # and the port's unsharded grouped step: densities exactly
    one = round_engine.GroupedRoundEngine().step(
        p_b, _t(g), w, rk, full_round=full_round, dense_masks=dense)
    assert torch.equal(one.densities, got.densities)
    for a, b in zip(tree.leaves(one.global_params),
                    tree.leaves(got.global_params)):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)


# --- the protocol -------------------------------------------------------------

def _btrain(stacked, rng):
    new = tree.tree_map(lambda l: l * 1.01 + 0.003, stacked)
    return new, torch.ones(tree.leaves(stacked)[0].shape[0])


def _server(**kw):
    cfg = ProtocolConfig(rounds=4, seed=0, **kw)
    return FedDDServer(t_params(np_params()), cfg, telemetry(13),
                       device="cpu")


def test_protocol_mesh_one_bit_equal_and_virtual_mesh_close():
    s0 = _server()
    s0.run(batched_train_fn=_btrain)
    s1 = _server(mesh=1)
    assert s1.executor_kind == "sharded"
    s1.run(batched_train_fn=_btrain)
    assert _equal(s0.global_params, s1.global_params)
    for kw in (dict(mesh=_virtual(8)),
               dict(mesh=_virtual(8), mesh_collective="sparse",
                    mesh_keep_fraction=1.0)):
        s = _server(**kw)
        s.run(batched_train_fn=_btrain)
        for a, b in zip(tree.leaves(s0.global_params),
                        tree.leaves(s.global_params)):
            torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)


def test_protocol_config_mesh_validations_and_loop_rejection(tmp_path):
    for kw, match in ((dict(rounds_per_dispatch=2, allocator="jax"),
                       "mutually exclusive"),
                      (dict(mesh_collective="ring"), "mesh_collective"),
                      (dict(mesh_keep_fraction=0.0), "mesh_keep_fraction"),
                      (dict(mesh_keep_fraction=1.5), "mesh_keep_fraction")):
        with pytest.raises(ValueError, match=match):
            ProtocolConfig(mesh=1, **kw)
    srv = _server(mesh=1, batched=False)
    with pytest.raises(ValueError, match="reference loop"):
        srv.run(local_train_fn=lambda p, i, r: (p, 1.0))
    # sparse compaction needs the homogeneous engine
    ragged = [t_params(np_sub_params(i, (12, 8)[i % 2])) for i in range(4)]
    tel = telemetry(4, 0, [nbytes(np_sub_params(i, (12, 8)[i % 2]))
                           for i in range(4)])
    srv = FedDDServer(t_params(np_params()), ProtocolConfig(
        rounds=1, mesh=1, mesh_collective="sparse"), tel, ragged,
        device="cpu")
    assert srv.executor_kind == "grouped"
    with pytest.raises(ValueError, match="dense collective"):
        srv.run(ltf_torch)
    # the sharded executor refuses a snapshot, as the JAX package's
    srv = _server(mesh=1, checkpoint_every=1,
                  checkpoint_path=str(tmp_path / "c"))
    with pytest.raises(NotImplementedError, match="checkpoint"):
        srv.run(batched_train_fn=_btrain)


def test_protocol_ragged_fleet_on_virtual_mesh_close_to_grouped():
    n = 6
    ragged = [t_params(np_sub_params(i, (12, 8, 4)[i % 3]))
              for i in range(n)]
    tel = telemetry(n, 0, [nbytes(np_sub_params(i, (12, 8, 4)[i % 3]))
                           for i in range(n)])

    def run(**kw):
        return FedDDServer(t_params(np_params()), ProtocolConfig(
            rounds=3, h=2, seed=0, **kw), tel, ragged, device="cpu").run(
            ltf_torch)
    a, b = run(), run(mesh=_virtual(3))
    for x, y in zip(tree.leaves(a.global_params), tree.leaves(b.global_params)):
        torch.testing.assert_close(x, y, rtol=2e-6, atol=2e-6)
    assert [r.uploaded_bytes for r in a.history] == \
        [r.uploaded_bytes for r in b.history]


def test_account_collective_reaches_obs(tmp_path):
    from repro_torch.obs import ObsConfig
    from repro_torch.obs.runlog import read_events
    log = tmp_path / "run.jsonl"
    srv = _server(mesh=_virtual(4), mesh_collective="sparse",
                  mesh_keep_fraction=0.5,
                  obs=ObsConfig(enabled=True, jsonl_path=str(log)))
    srv.run(batched_train_fn=_btrain)
    events = [e for e in read_events(str(log)) if e.get("event") ==
              "collective"]
    spec = WireSpec.from_params(t_params(np_params()), -1)
    dense, actual = account_collective(spec, 4, mode="sparse",
                                       k_fraction=0.5)
    assert len(events) == 4
    assert all(e["dense"] == dense and e["wire"] == actual for e in events)
    assert actual < dense

    class _Rec:
        active = True
        calls = []

        def collective(self, d, a):
            self.calls.append((d, a))
    rec = _Rec()
    assert account_collective(spec, 2, obs=rec) == rec.calls[0]


# --- the simulator -------------------------------------------------------------

def test_sim_mesh_one_bit_equal_and_guards():
    from repro_torch import sim
    from repro_torch.population import Population
    n = 13
    kw = dict(rounds=3, seed=0, device="cpu")
    r0 = sim.run_sim("feddd", t_params(np_params()), telemetry(n), ltf_torch,
                     None, **kw)
    r1 = sim.run_sim("feddd", t_params(np_params()), telemetry(n), ltf_torch,
                     None, mesh=1, **kw)
    assert _equal(r0.global_params, r1.global_params)
    assert [h.sim_time for h in r0.history] == \
        [h.sim_time for h in r1.history]
    r8 = sim.run_sim("feddd", t_params(np_params()), telemetry(n), ltf_torch,
                     None, mesh=_virtual(8), **kw)
    for a, b in zip(tree.leaves(r0.global_params),
                    tree.leaves(r8.global_params)):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)
    base = dict(rounds=2, device="cpu")
    ragged = [t_params(np_sub_params(i, (12, 8)[i % 2])) for i in range(4)]
    tel = telemetry(4, 0, [nbytes(np_sub_params(i, (12, 8)[i % 2]))
                           for i in range(4)])
    # a ragged fleet's wave rounds on the sharded grouped step
    g0, g2 = (sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch,
                          None, client_params=ragged, **base, **kw_)
              .global_params for kw_ in ({}, dict(mesh=_virtual(2))))
    for a, b in zip(tree.leaves(g0), tree.leaves(g2)):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)
    with pytest.raises(ValueError, match="dense collective"):
        sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch, None,
                    client_params=ragged, mesh=1, mesh_collective="sparse",
                    mesh_keep_fraction=0.5, **base)
    pop = Population(telemetry(8), availability="bernoulli", seed=0)
    with pytest.raises(ValueError, match="static cohort"):
        sim.run_sim("feddd", t_params(np_params()), telemetry(8), ltf_torch,
                    None, population=pop, cohort_size=4, mesh=1, **base)


# --- the quickstart -------------------------------------------------------------

def test_quickstart_mesh_flag(capsys):
    from repro_torch import quickstart
    a, _, _ = quickstart.run(1, fedavg_rounds=0, device="cpu")
    b, _, _ = quickstart.run(1, fedavg_rounds=0, device="cpu", mesh=4)
    assert _equal(a.global_params, b.global_params)
    with pytest.raises(SystemExit):
        quickstart.main(["--mesh", "2", "--loop", "--device", "cpu"])
    assert "--mesh requires the batched engine" in capsys.readouterr().err


# --- against the JAX package's 4-device sharded engine (one subprocess) ---------

_JAX_FOUR = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import round_engine as jre
from repro.core.selection import SelectionConfig
from repro.launch.mesh import make_client_mesh
n = 13
rng = np.random.default_rng(0)
g = {"w": rng.normal(size=(4, 8)).astype(np.float32),
     "b": rng.normal(size=(8,)).astype(np.float32)}
old = {k: np.stack([v * np.float32(1 + 0.01 * i) for i in range(n)])
       for k, v in g.items()}
new = {k: (v * np.float32(1.01) + np.float32(0.002)).astype(np.float32)
       for k, v in old.items()}
w = np.arange(1, n + 1, dtype=np.float32)
m = make_client_mesh(4)
assert m.devices.size == 4
out = {}
for name, coll, keep, d in (
        ("dense", "dense", 1.0, np.linspace(0.0, 0.6, n)),
        ("sparse08", "sparse", 0.8, np.full(n, 0.75)),
        ("zero", "sparse", 0.8, np.zeros(n))):
    eng = jre.ShardedRoundEngine(SelectionConfig(), mesh=m, collective=coll,
                                 keep_fraction=keep)
    o = eng.step(jax.tree_util.tree_map(jnp.asarray, old),
                 jax.tree_util.tree_map(jnp.asarray, new),
                 jax.tree_util.tree_map(jnp.asarray, g),
                 jnp.asarray(d, jnp.float32), jnp.asarray(w),
                 jax.random.PRNGKey(3), full_round=False)
    for k in ("w", "b"):
        out[f"{name}/global/{k}"] = np.asarray(o.global_params[k])
        out[f"{name}/clients/{k}"] = np.asarray(o.client_params[k])
    out[f"{name}/densities"] = np.asarray(o.densities)
    out[f"{name}/overflow"] = np.asarray(o.collective_overflow)
np.savez(sys.argv[1], **out)
"""


def test_four_virtual_shards_match_jax_four_devices(tmp_path):
    path = tmp_path / "jax4.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_FOUR),
                    str(path)], env=env, check=True, timeout=300,
                   capture_output=True)
    want = np.load(path)
    n = 13
    g, old, new, w = _fleet_np(n)
    rk = np.asarray(jax.random.PRNGKey(3))
    seen = {}
    for name, coll, keep, d in (
            ("dense", "dense", 1.0, np.linspace(0.0, 0.6, n)),
            ("sparse08", "sparse", 0.8, np.full(n, 0.75)),
            ("zero", "sparse", 0.8, np.zeros(n))):
        got = round_engine.ShardedRoundEngine(
            mesh=_virtual(4), collective=coll, keep_fraction=keep).step(
            _t(old), _t(new), _t(g), d.astype(np.float32), w, rk,
            full_round=False)
        np.testing.assert_array_equal(got.densities.numpy(),
                                      want[f"{name}/densities"])
        assert float(got.collective_overflow) == \
            float(want[f"{name}/overflow"])
        seen[name] = float(got.collective_overflow)
        for k in ("w", "b"):
            np.testing.assert_allclose(got.global_params[k].numpy(),
                                       want[f"{name}/global/{k}"],
                                       rtol=2e-6, atol=2e-6)
            np.testing.assert_allclose(got.client_params[k].numpy(),
                                       want[f"{name}/clients/{k}"],
                                       rtol=2e-6, atol=2e-6)
    assert seen["dense"] == seen["sparse08"] == 0.0 and seen["zero"] > 0.0
