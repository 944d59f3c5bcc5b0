"""The port's quickstart CLI (``python -m repro_torch.quickstart``) against
the JAX package's ``examples/quickstart.py``.

* the fault, outage, robust-aggregation and population flags: the port's
  ``scheme_kwargs`` against the reference's own construction
  (``examples/quickstart.py`` with ``repro.sim`` and ``repro.population``),
  each run for 2 FedDD rounds at the cut size of
  ``test_torch_protocol._quickstart_pieces`` (synthetic MNIST 1200/300)
  from the JAX package's initial parameters: survivors, skipped rounds,
  the served cohorts, ``uploaded_fraction`` and ``wire_bytes`` exactly,
  ``sim_time`` to rtol 1e-6, the global parameters to atol 1e-5 and the
  accuracy within one test sample;
* the reference's four argument errors, through ``main``;
* ``--checkpoint-dir`` then ``--resume`` equals the uninterrupted run bit
  for bit;
* the port's CLIs take every flag of the reference's (``--help`` in
  subprocesses): the quickstart's plus ``--device``, ``perf_federated``'s
  plus ``--device`` and ``--results-dir``.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import population as jpop
from repro import sim as jsim
from repro.core import protocol as jax_protocol
from repro.data import partition as jax_part
from repro.data import synthetic as jax_synth
from repro.fl import heterogeneity as jax_het
from repro.fl import models as jax_models
from repro_torch import convert, quickstart, tree
from repro_torch.core import protocol
from repro_torch.data import partition, synthetic
from repro_torch.fl import heterogeneity, models

from test_torch_protocol import _jax_params
from torch_parity import assert_trees_close

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 2
NUM_TEST = 300


@pytest.fixture(autouse=True)
def _one_thread():
    """Bit-for-bit comparisons of two runs pin one CPU thread (a float32
    reduction's blocking can change with the thread count)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pieces(syn, part, het, fl, clients, **kw):
    """The quickstart's data, partition, telemetry, trainer and eval at
    the cut size (1200/300, ``clients`` non-IID shards, lr 0.1)."""
    train, test = syn.make_dataset("mnist", num_train=1200,
                                   num_test=NUM_TEST)
    parts = part.partition_noniid_b(train, clients, seed=0)
    nbytes = jax_models.model_bytes(_jax_params())
    tel = het.sample_system_telemetry(
        clients, [nbytes] * clients, [len(p) for p in parts],
        [part.label_coverage_score(train, p) for p in parts], seed=0)
    return (train, parts, tel,
            fl.make_local_train_fn(fl.MLP_SPEC, train, parts, flatten=True,
                                   lr=0.1, **kw),
            fl.make_eval_fn(fl.MLP_SPEC, test, flatten=True, **kw))


def _reference_kwargs(clients, train, parts, tel, ltf, fault_rate=0.0,
                      quorum=1, cells=0, robust_agg="mean", population=None,
                      cohort=None, availability="always"):
    """``examples/quickstart.py``'s construction of the FedDD run's
    telemetry, trainer and keyword arguments, with the JAX package."""
    kw = {}
    if population is not None:
        P, shards = population, clients
        tel = jax_het.sample_system_telemetry(
            P, [float(tel.model_bytes[0])] * P,
            [len(parts[g % shards]) for g in range(P)],
            [jax_part.label_coverage_score(train, parts[g % shards])
             for g in range(P)], seed=0)
        shard_ltf = ltf

        def ltf(p, gid, key):
            return shard_ltf(p, int(gid) % shards, key)

        kw["population"] = jpop.Population(
            tel, availability=availability, sampler="uniform", seed=0)
        kw["cohort_size"] = cohort
    faults = None
    if fault_rate > 0.0:
        faults = jsim.RandomFaults(jsim.FaultConfig(
            crash_rate=fault_rate / 2, loss_rate=fault_rate,
            corrupt_rate=fault_rate / 4, quorum=quorum, seed=0))
    if cells > 0:
        faults = jsim.CellOutageModel(
            clients, jsim.OutageConfig(cells=cells, p_out=0.15, p_back=0.5,
                                       seed=0), inner=faults)
    if robust_agg != "mean":
        kw["robust_agg"] = robust_agg
    return tel, ltf, dict(faults=faults, **kw)


_PIECES = {}


def _both_pieces(clients):
    """Both packages' pieces, built once a client count (the JAX package's
    trainer and eval keep their compiled functions across the cases)."""
    if clients not in _PIECES:
        _PIECES[clients] = (
            _pieces(jax_synth, jax_part, jax_het, jax_models, clients),
            _pieces(synthetic, partition, heterogeneity, models, clients,
                    device="cpu"))
    return _PIECES[clients]


STORE_FIELDS = ("seen", "last_round", "rounds_participated", "failures")


def _fault_configs(model) -> list:
    """A fault model's configuration, outage layer first, as plain dicts."""
    out = []
    if hasattr(model, "outage"):
        out.append(("outage", dataclasses.asdict(model.outage),
                    model.num_clients))
        model = model.inner
    if model is not None:
        out.append(("faults", dataclasses.asdict(model.config)))
    return out


@pytest.mark.parametrize("clients,flags", [
    (10, dict(fault_rate=0.2, quorum=2)),
    (10, dict(cells=3, fault_rate=0.2)),
    (10, dict(robust_agg="trimmed:0.2")),
    (10, dict(robust_agg="clip:2.0")),
    (4, dict(population=40, cohort=8, availability="bernoulli")),
    (4, dict(population=40, availability="diurnal")),
], ids=["faults-quorum2", "cells3-faults", "trimmed", "clip",
        "population-cohort-bernoulli", "population-diurnal"])
def test_flags_match_the_reference(clients, flags):
    (jtrain, jparts, jtel, jltf, jef), (_, _, ttel, tltf, tef) = \
        _both_pieces(clients)
    params = _jax_params()
    run_kw = dict(rounds=ROUNDS, a_server=0.6, h=quickstart.FEDDD_H)
    jtel, jltf, jkw = _reference_kwargs(clients, jtrain, jparts, jtel, jltf,
                                        **flags)
    want = jax_protocol.run_scheme(
        "feddd", jax.tree_util.tree_map(jnp.asarray, params), jtel, jltf,
        jef, **jkw, **run_kw)
    sk = quickstart.scheme_kwargs(ttel, tltf, **flags)
    got = protocol.run_scheme(
        "feddd", convert.to_torch(params, "cpu"), sk.telemetry,
        sk.local_train_fn, tef, device="cpu", **sk.feddd, **run_kw)

    assert len(got.history) == len(want.history) == ROUNDS
    for g, w in zip(got.history, want.history):
        for field in ("survivors", "skipped", "uploaded_fraction",
                      "wire_bytes"):
            assert getattr(g, field) == getattr(w, field), field
        np.testing.assert_allclose(g.sim_time, w.sim_time, rtol=1e-6)
        assert abs(g.metrics["accuracy"] - w.metrics["accuracy"]) <= \
            1.0 / NUM_TEST + 1e-12
    assert_trees_close(got.global_params, want.global_params, rtol=0,
                       atol=1e-5)
    if hasattr(want, "event_trace"):       # the simulator's runs
        assert [(k, c) for _, k, c in got.event_trace] == \
            [(k, c) for _, k, c in want.event_trace]
    if "faults" in sk.feddd:
        assert any(r.survivors < clients or r.retries for r in got.history)
        assert _fault_configs(sk.feddd["faults"]) == \
            _fault_configs(jkw["faults"])
    if "population" in flags:
        served, ref = sk.feddd["population"], jkw["population"]
        assert sk.telemetry.num_clients == flags["population"]
        for f in STORE_FIELDS:
            np.testing.assert_array_equal(getattr(served, f),
                                          getattr(ref, f), err_msg=f)
        assert served.seen.any()
        # FedAvg serves a fresh store with the same population arguments
        fedavg = sk.fedavg()
        assert set(fedavg) == {"population", "cohort_size"}
        assert fedavg["population"] is not served
        assert not fedavg["population"].seen.any()
        assert fedavg["cohort_size"] == flags.get("cohort")


# --- argument errors -----------------------------------------------------------

@pytest.mark.parametrize("argv,message", [
    (["--cohort", "8"], "--cohort requires --population"),
    (["--resume"], "--resume requires --checkpoint-dir"),
    (["--resume", "--checkpoint-dir", "{tmp}"], "--resume: no checkpoint at"),
    (["--mesh", "2", "--loop"], "--mesh requires the batched engine"),
], ids=["cohort", "resume", "resume-no-snapshot", "mesh-loop"])
def test_argument_errors(argv, message, tmp_path, capsys):
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    with pytest.raises(SystemExit) as e:
        quickstart.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


# --- crash-resume --------------------------------------------------------------

def _same_runs(a, b):
    assert len(a.history) == len(b.history)
    for x, y in zip(a.history, b.history):
        for f in ("round", "sim_time", "sim_round_time", "mean_loss",
                  "uploaded_fraction", "uploaded_bytes", "wire_bytes",
                  "participants", "epsilon", "metrics", "survivors",
                  "retries", "abandoned_bytes", "quarantined_bytes",
                  "skipped"):
            assert getattr(x, f) == getattr(y, f), (x.round, f)
        np.testing.assert_array_equal(x.dropout_rates, y.dropout_rates)
    for x, y in zip(tree.leaves(a.global_params),
                    tree.leaves(b.global_params)):
        assert torch.equal(x, y)


def test_checkpoint_then_resume_equals_uninterrupted(tmp_path, capsys):
    base = ["--device", "cpu", "--checkpoint-dir", str(tmp_path)]
    quickstart.main(["--rounds", "2"] + base)
    assert (tmp_path / quickstart.CHECKPOINT_FILE).exists()
    resumed, _ = quickstart.main(["--rounds", "3", "--resume"] + base)
    full, _ = quickstart.main(["--rounds", "3", "--device", "cpu"])
    assert [r.round for r in resumed.history] == [1, 2, 3]
    _same_runs(resumed, full)
    out = capsys.readouterr().out
    assert "== FedDD (A_server=0.6, batched round engine" in out
    assert "== FedAvg (full uploads) ==" in out


# --- flag sets -----------------------------------------------------------------

def _flags(help_text: str) -> set:
    """The option strings of an argparse ``--help`` (its option lines, not
    the flags its help texts mention)."""
    out = set()
    for line in help_text.splitlines():
        body = line.strip()
        if line.startswith("  ") and body.startswith("-"):
            out.update(re.findall(r"--[\w-]+", re.split(r"\s{2,}", body)[0]))
    return out


def test_port_takes_every_reference_flag():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    cmds = {
        "quickstart": [str(ROOT / "examples" / "quickstart.py")],
        "quickstart_torch": ["-m", "repro_torch.quickstart"],
        "perf": [str(ROOT / "src" / "repro" / "launch" /
                     "perf_federated.py")],
        "perf_torch": ["-m", "repro_torch.launch.perf_federated"],
    }
    procs = {k: subprocess.Popen([sys.executable, *v, "--help"], cwd=ROOT,
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, v in cmds.items()}
    helps = {}
    for k, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, (k, err[-2000:])
        helps[k] = _flags(out)
    assert {"--fault-rate", "--population", "--mesh"} <= helps["quickstart"]
    assert helps["quickstart_torch"] == helps["quickstart"] | {"--device"}
    assert "--rates" in helps["perf"]
    assert helps["perf_torch"] == helps["perf"] | {"--device",
                                                   "--results-dir"}
