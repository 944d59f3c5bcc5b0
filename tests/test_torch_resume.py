"""Crash-resume in the port (``repro_torch.checkpoint``, the protocol's
engine and loop executors, the simulator's wave policies), and snapshots
carried across the two packages.

* a ``RunState`` round-trips exactly (float64 host state stays float64,
  records by their float64 repr);
* a snapshot the JAX package's ``save_run_state`` wrote — with a JSON
  sidecar and with a msgpack one — loads into the port with equal arrays
  and history, and one the port wrote loads into the JAX package;
* checkpointing on changes nothing (protocol engine and loop, sim);
* a resumed run equals the uninterrupted one bit for bit (protocol
  engine and loop; the sim with faults, outages and obs; a ragged wave
  fleet), and a process killed with SIGKILL after a snapshot resumes to
  the uninterrupted process's digest;
* the paths that hold state a snapshot does not capture raise.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core.protocol import RoundRecord as JaxRecord
from repro_torch import checkpoint as ckpt
from repro_torch import obs, sim, tree
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import protocol
from repro_torch.core.protocol import ProtocolConfig, RoundRecord

from torch_sim_parity import (ltf_torch, nbytes, np_params, np_sub_params,
                              t_params, telemetry, trees_equal)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_tree(np_tree):
    return jax.tree_util.tree_map(jnp.asarray, np_tree)


def _records_identical(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for f in ("round", "sim_time", "mean_loss", "participants",
                  "uploaded_bytes", "wire_bytes", "survivors", "retries",
                  "abandoned_bytes", "quarantined_bytes", "skipped",
                  "uploaded_fraction"):
            assert getattr(ra, f) == getattr(rb, f), f
        np.testing.assert_array_equal(ra.dropout_rates, rb.dropout_rates)


def _history(cls):
    return [cls(round=1, sim_time=1.23456789012345e2, sim_round_time=1.0,
                host_wall_time=0.5, mean_loss=1 / 3, uploaded_bytes=1e5,
                wire_bytes=9.9e4, uploaded_fraction=0.5, participants=4,
                survivors=3, retries=2, abandoned_bytes=17.5,
                dropout_rates=np.asarray([0.1, 0.2]))]


# --- RunState and the file format ---------------------------------------------

def test_run_state_round_trip_exact(tmp_path):
    arrays = {"global": {"w": torch.arange(6.0).reshape(2, 3),
                         "h": torch.ones(3, dtype=torch.bfloat16)},
              "rng": np.array([7, 9], np.uint32),
              "losses": np.asarray([0.1, 1 / 3], np.float64)}
    history = _history(RoundRecord)
    path = tmp_path / "state.npz"
    ckpt.save_run_state(path, ckpt.RunState(
        round=1, arrays=arrays, history=history, extra={"sim_time": 123.5,
                                                        "trace": [[1.5, "a",
                                                                   2]]}))
    st = ckpt.load_run_state(path, arrays)
    assert st.round == 1
    assert st.extra == {"sim_time": 123.5, "trace": [[1.5, "a", 2]]}
    assert trees_equal(st.arrays["global"], arrays["global"])
    assert st.arrays["global"]["h"].dtype == torch.bfloat16
    assert st.arrays["losses"].dtype == np.float64
    np.testing.assert_array_equal(st.arrays["losses"], arrays["losses"])
    np.testing.assert_array_equal(st.arrays["rng"], arrays["rng"])
    _records_identical(st.history, history)
    plain = tmp_path / "plain.npz"
    ckpt.save_checkpoint(plain, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="not a RunState snapshot"):
        ckpt.load_run_state(plain, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_checkpoint(plain, {"w": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing"):
        ckpt.load_checkpoint(plain, {"v": torch.zeros(3)})


@pytest.mark.parametrize("sidecar", ["json", "msgpack"])
def test_jax_package_snapshot_loads_into_port(sidecar, tmp_path,
                                              monkeypatch):
    """The state carried across packages: the npz keys are the same
    ``keystr`` paths and the sidecar parses in either format."""
    monkeypatch.setattr(jckpt.io, "_HAVE_MSGPACK", sidecar == "msgpack")
    p = np_params(4)
    arrays = {"executor": {"stacked": {k: {m: np.stack([v, v + 1])
                                           for m, v in sub.items()}
                                       for k, sub in p.items()}},
              "global": p, "rng": np.array([11, 3], np.uint32),
              "losses": np.asarray([0.25, 1 / 7], np.float64),
              "dropout": np.asarray([0.0, 0.4], np.float64)}
    path = tmp_path / "jax.npz"
    jckpt.save_run_state(path, jckpt.RunState(
        round=3, arrays={k: (jnp.asarray(v) if k == "rng" else
                             (v if k in ("losses", "dropout") else
                              jax_tree(v))) for k, v in arrays.items()},
        history=_history(JaxRecord), extra={"sim_time": 9.75}))
    raw = Path(str(path) + ".meta").read_bytes()
    assert raw.startswith(b"{") == (sidecar == "json")
    like = {"executor": {"stacked": t_params(arrays["executor"]["stacked"])},
            "global": t_params(p), "rng": np.zeros(2, np.uint32),
            "losses": np.zeros(2), "dropout": np.zeros(2)}
    st = ckpt.load_run_state(path, like)
    assert st.round == 3 and st.extra == {"sim_time": 9.75}
    assert trees_equal(st.arrays["global"], t_params(p))
    assert trees_equal(st.arrays["executor"],
                       {"stacked": t_params(arrays["executor"]["stacked"])})
    for k in ("rng", "losses", "dropout"):
        np.testing.assert_array_equal(st.arrays[k], arrays[k])
        assert st.arrays[k].dtype == arrays[k].dtype
    _records_identical(st.history, _history(RoundRecord))
    # and back: the port's snapshot (in the same sidecar format) loads
    # into the JAX package
    monkeypatch.setattr(ckpt_io, "_HAVE_MSGPACK", sidecar == "msgpack")
    back = tmp_path / "port.npz"
    ckpt.save_run_state(back, st)
    jst = jckpt.load_run_state(back, {k: (jnp.asarray(v) if k == "rng" else
                                          (v if k in ("losses", "dropout")
                                           else jax_tree(v)))
                                      for k, v in arrays.items()})
    assert jst.round == 3
    np.testing.assert_array_equal(np.asarray(jst.arrays["global"]["fc0"]["w"]),
                                  p["fc0"]["w"])


def test_sidecar_without_msgpack_raises_clearly(tmp_path, monkeypatch):
    path = tmp_path / "m.npz"
    ckpt.save_checkpoint(path, {"w": torch.zeros(2)}, metadata={"a": 1})
    if ckpt_io._HAVE_MSGPACK:
        monkeypatch.setattr(ckpt_io, "_HAVE_MSGPACK", False)
        with pytest.raises(ValueError, match="msgpack package"):
            ckpt.load_checkpoint(path, {"w": torch.zeros(2)})
    # without msgpack the port writes JSON, and reads it back
    monkeypatch.setattr(ckpt_io, "_HAVE_MSGPACK", False)
    ckpt.save_checkpoint(path, {"w": torch.zeros(2)}, metadata={"a": 1})
    assert Path(str(path) + ".meta").read_bytes().startswith(b"{")
    assert ckpt.load_checkpoint(path, {"w": torch.zeros(2)})[1]["a"] == 1


def test_checkpoint_config_validation():
    with pytest.raises(ValueError, match="checkpoint_every must be >= 1"):
        ProtocolConfig(checkpoint_every=0, checkpoint_path="x")
    with pytest.raises(ValueError, match="requires\\s+checkpoint_path"):
        ProtocolConfig(checkpoint_every=1)
    with pytest.raises(ValueError, match="dispatch\\s+boundaries"):
        ProtocolConfig(checkpoint_every=1, checkpoint_path="x",
                       rounds_per_dispatch=2, allocator="jax")
    # a client mesh takes checkpointing at the config (its executor
    # refuses the snapshot, as the JAX package's), but not a scanned chunk
    assert ProtocolConfig(mesh=1, checkpoint_every=1,
                          checkpoint_path="x").mesh == 1
    with pytest.raises(ValueError, match="mutually exclusive"):
        ProtocolConfig(mesh=1, rounds_per_dispatch=2, allocator="jax")


# --- the protocol's executors ---------------------------------------------------

@pytest.mark.parametrize("batched", [True, False])
def test_checkpointing_on_is_inert_protocol(batched, tmp_path):
    n = 5
    kw = dict(rounds=4, a_server=0.6, h=2, seed=0, batched=batched,
              device="cpu")
    ref = protocol.run_scheme("feddd", t_params(np_params()), telemetry(n),
                              ltf_torch, None, **kw)
    got = protocol.run_scheme("feddd", t_params(np_params()), telemetry(n),
                              ltf_torch, None, checkpoint_every=1,
                              checkpoint_path=str(tmp_path / "ck.npz"), **kw)
    assert trees_equal(ref.global_params, got.global_params)
    _records_identical(ref.history, got.history)


@pytest.mark.parametrize("batched", [True, False])
def test_resume_bit_identical_protocol(batched, tmp_path):
    n = 5
    path = str(tmp_path / "ck.npz")
    kw = dict(a_server=0.6, h=2, seed=0, batched=batched, device="cpu")
    full = protocol.run_scheme("feddd", t_params(np_params()), telemetry(n),
                               ltf_torch, None, rounds=6, **kw)
    protocol.run_scheme("feddd", t_params(np_params()), telemetry(n),
                        ltf_torch, None, rounds=3, checkpoint_every=1,
                        checkpoint_path=path, **kw)
    resumed = protocol.run_scheme("feddd", t_params(np_params()),
                                  telemetry(n), ltf_torch, None, rounds=6,
                                  checkpoint_every=1, checkpoint_path=path,
                                  resume_from=path, **kw)
    assert trees_equal(full.global_params, resumed.global_params)
    _records_identical(full.history, resumed.history)


def test_unsupported_executors_raise_loudly(tmp_path):
    n = 4
    kw = dict(rounds=2, a_server=0.6, h=2, seed=0, checkpoint_every=1,
              checkpoint_path=str(tmp_path / "ck.npz"), device="cpu")
    subs = [np_sub_params(100 + i, (12, 8)[i % 2]) for i in range(n)]
    with pytest.raises(NotImplementedError, match="batched-engine"):
        protocol.run_scheme("feddd", t_params(np_params()),
                            telemetry(n, 0, [nbytes(s) for s in subs]),
                            ltf_torch, None,
                            client_params=[t_params(s) for s in subs], **kw)
    with pytest.raises(ValueError, match="wave-round boundaries"):
        sim.run_sim("feddd", t_params(np_params()), telemetry(n), ltf_torch,
                    None, sim=sim.SimConfig(policy="async"), **kw)


# --- the simulator ---------------------------------------------------------------

def _sim_kw(n, tmp_path=None, log=None):
    from repro_torch.obs import ObsConfig
    faults = sim.CellOutageModel(
        n, sim.OutageConfig(cells=2, p_out=0.3, p_back=0.5, seed=3),
        inner=sim.RandomFaults(crash_rate=0.15, loss_rate=0.1, seed=5))
    kw = dict(sim=sim.SimConfig(policy="sync"), faults=faults,
              a_server=0.6, h=2, seed=0, device="cpu")
    if log is not None:
        kw["obs"] = ObsConfig(enabled=True, jsonl_path=str(tmp_path / log))
    return kw


def test_resume_bit_identical_sim_with_faults_and_obs(tmp_path):
    n = 5
    path = str(tmp_path / "ck.npz")
    full = sim.run_sim("feddd", t_params(np_params()), telemetry(n),
                       ltf_torch, None, rounds=6,
                       **_sim_kw(n, tmp_path, "full.jsonl"))
    sim.run_sim("feddd", t_params(np_params()), telemetry(n), ltf_torch,
                None, rounds=3, checkpoint_every=1, checkpoint_path=path,
                **_sim_kw(n, tmp_path, "part.jsonl"))
    resumed = sim.run_sim("feddd", t_params(np_params()), telemetry(n),
                          ltf_torch, None, rounds=6, checkpoint_every=1,
                          checkpoint_path=path, resume_from=path,
                          **_sim_kw(n, tmp_path, "resumed.jsonl"))
    assert trees_equal(full.global_params, resumed.global_params)
    _records_identical(full.history, resumed.history)
    assert full.event_trace == resumed.event_trace


def test_resume_bit_identical_ragged_wave_fleet(tmp_path):
    n, widths = 4, (12, 8)
    subs = [np_sub_params(100 + i, widths[i % 2]) for i in range(n)]
    tel = telemetry(n, 0, [nbytes(s) for s in subs])
    path = str(tmp_path / "ck.npz")
    kw = dict(sim=sim.SimConfig(policy="sync"),
              client_params=[t_params(s) for s in subs],
              faults=sim.RandomFaults(crash_rate=0.2, seed=4),
              a_server=0.6, h=2, seed=0, device="cpu")
    full = sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch, None,
                       rounds=5, **kw)
    sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch, None,
                rounds=2, checkpoint_every=1, checkpoint_path=path, **kw)
    resumed = sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch,
                          None, rounds=5, checkpoint_every=1,
                          checkpoint_path=path, resume_from=path, **kw)
    assert trees_equal(full.global_params, resumed.global_params)
    _records_identical(full.history, resumed.history)
    assert full.event_trace == resumed.event_trace


def test_checkpointing_on_is_inert_sim(tmp_path):
    n = 5
    ref = sim.run_sim("feddd", t_params(np_params()), telemetry(n),
                      ltf_torch, None, rounds=4, **_sim_kw(n))
    got = sim.run_sim("feddd", t_params(np_params()), telemetry(n),
                      ltf_torch, None, rounds=4, checkpoint_every=2,
                      checkpoint_path=str(tmp_path / "ck.npz"),
                      **_sim_kw(n))
    assert trees_equal(ref.global_params, got.global_params)
    _records_identical(ref.history, got.history)
    assert ref.event_trace == got.event_trace


# --- the SIGKILL acceptance -----------------------------------------------------

def _run_mode(mode, tmp_path):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.sim.crash_resume", mode,
         str(tmp_path / "ck.npz"), "--rounds", "6", "--clients", "6",
         "--every", "2", "--kill-round", "5",
         "--log", str(tmp_path / f"{mode}.jsonl"), "--device", "cpu"],
        capture_output=True, text=True, check=False, cwd=str(tmp_path),
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})


def test_sigkill_resume_bit_identical_digest(tmp_path):
    """A process killed with SIGKILL in round 5 (after its round-2 and
    round-4 snapshots) of a faulty, outage-ridden, obs-enabled run, then
    resumed from its last atomic snapshot, prints the uninterrupted
    process's digest."""
    full = _run_mode("full", tmp_path)
    assert full.returncode == 0, full.stderr[-2000:]
    crashed = _run_mode("crash", tmp_path)
    assert crashed.returncode == -9, crashed.stderr[-2000:]
    # the killed run's log holds the rounds it finished
    rounds = [e["round"] for e in obs.read_events(
        str(tmp_path / "crash.jsonl")) if e["event"] == "round"]
    assert rounds == [1, 2, 3, 4]
    meta = ckpt_io.decode_meta((tmp_path / "ck.npz.meta").read_bytes())
    assert meta["round"] == 4
    resumed = _run_mode("resume", tmp_path)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert resumed.stdout.strip() == full.stdout.strip()
    assert len(full.stdout.strip()) == 64
