"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``), and its contracts on the port's runs.

* Obs on equals obs off bit for bit on the engine and the loop (every
  ``RoundRecord`` field but ``host_wall_time``, and the parameters), with
  the same number of device-to-host reads: ``protocol._to_host`` (the
  engine round's one copy) and ``protocol._host_float`` (the loop's
  per-client density and epsilon reads) are counted.
* The JSONL log round-trips to the history exactly, and its events carry
  each executor's phase names.
* ``repro.obs.report`` and ``repro_torch.obs.report`` render the port's
  events to identical text, CSV and Prometheus exports; a
  ``MetricsRegistry`` fed the same calls renders identical Prometheus and
  CSV text in both packages.
* The engine step's phases carry the JAX engine's scope names in a
  torch.profiler trace, and ``ObsConfig(trace=True)`` spans appear there.

The runs are the quickstart configuration at reduced size (1200/300
samples, 10 clients) with the real trainer, 3 rounds.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro.obs import metrics as jax_metrics
from repro.obs import report as jax_report
from repro_torch import convert, obs, tree
from repro_torch.core import protocol
from repro_torch.data import partition, synthetic
from repro_torch.fl import heterogeneity, models
from repro_torch.obs import report

from test_torch_protocol import _jax_params, _quickstart_pieces

PATHS = {"engine": dict(), "loop": dict(batched=False, track_epsilon=True)}
ENGINE_SPANS = {"local_train", "engine_step", "host_transfer", "allocate",
                "eval"}
LOOP_SPANS = {"local_train", "encode", "aggregate", "client_update",
              "allocate", "eval"}


@pytest.fixture
def one_thread():
    """One intra-op thread: the CPU's float32 GEMMs block the same way in
    every run, so two runs can be compared bit for bit."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(path, cfg_obs=None, rounds=3, scheme="feddd"):
    tel, ltf, ef = _quickstart_pieces(synthetic, partition, heterogeneity,
                                      models, device="cpu")
    kw = dict(PATHS[path])
    if cfg_obs is not None:
        kw["obs"] = cfg_obs
    return protocol.run_scheme(
        scheme, convert.to_torch(_jax_params(), "cpu"), tel, ltf, ef,
        rounds=rounds, a_server=0.6, h=5, seed=0, device="cpu", **kw)


def _fields(rec):
    d = dataclasses.asdict(rec)
    d.pop("host_wall_time")
    d["dropout_rates"] = d["dropout_rates"].tolist()
    return d


@pytest.mark.parametrize("path", sorted(PATHS))
def test_obs_on_equals_obs_off(path, tmp_path, monkeypatch, one_thread):
    reads = {"to_host": 0, "host_float": 0}
    to_host, host_float = protocol._to_host, protocol._host_float

    def counted_to_host(*a):
        reads["to_host"] += 1
        return to_host(*a)

    def counted_host_float(x):
        reads["host_float"] += 1
        return host_float(x)

    monkeypatch.setattr(protocol, "_to_host", counted_to_host)
    monkeypatch.setattr(protocol, "_host_float", counted_host_float)
    off = _run(path)
    reads_off = dict(reads)
    reads.update(to_host=0, host_float=0)
    on = _run(path, obs.ObsConfig(enabled=True,
                                  jsonl_path=str(tmp_path / "run.jsonl")))
    assert reads == reads_off
    if path == "engine":
        assert reads_off == {"to_host": 3, "host_float": 0}
    else:   # a density read per client and round, and the epsilon
        assert reads_off == {"to_host": 0, "host_float": 3 * (10 + 1)}
    assert [_fields(r) for r in on.history] == [_fields(r)
                                                for r in off.history]
    for a, b in zip(tree.leaves(on.global_params),
                    tree.leaves(off.global_params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_jsonl_roundtrips_the_history_exactly(path, tmp_path):
    log = tmp_path / "run.jsonl"
    res = _run(path, obs.ObsConfig(jsonl_path=str(log)))
    back = obs.load_history(str(log))
    assert len(back) == len(res.history) == 3
    for a, b in zip(res.history, back):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        np.testing.assert_array_equal(da.pop("dropout_rates"),
                                      db.pop("dropout_rates"))
        assert da == db
    assert (back[-1].epsilon is not None) == (path == "loop")
    events = obs.read_events(str(log))
    assert events[0]["event"] == "run_start"
    assert events[0]["schema"] == obs.SCHEMA_VERSION == 1
    assert events[0]["executor"] == path and events[-1]["event"] == "run_end"
    spans = {e["name"] for e in events if e["event"] == "span"}
    assert spans == (ENGINE_SPANS if path == "engine" else LOOP_SPANS)
    assert spans <= set(obs.PHASES)
    rounds = [e for e in events if e["event"] == "round"]
    assert [e["round"] for e in rounds] == [1, 2, 3]
    assert all(e["path"] == path and len(e["client_up"]) == 10
               for e in rounds)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_report_renders_like_the_jax_report(path, tmp_path):
    log = tmp_path / "run.jsonl"
    _run(path, obs.ObsConfig(jsonl_path=str(log)))
    events = obs.read_events(str(log))
    text = report.render(events, top=4)
    assert text == jax_report.render(events, top=4)
    assert "Phase breakdown (host spans)" in text
    assert ("engine_step" if path == "engine" else "encode") in text
    assert report.rounds_csv(events) == jax_report.rounds_csv(events)
    assert (report.registry_from_events(events).prometheus_text()
            == jax_report.registry_from_events(events).prometheus_text())


def test_report_cli_writes_csv_and_prometheus(tmp_path, capsys):
    log = tmp_path / "run.jsonl"
    _run("engine", obs.ObsConfig(jsonl_path=str(log)), rounds=2)
    csv, prom = tmp_path / "r.csv", tmp_path / "m.prom"
    assert report.main([str(log), "--csv", str(csv), "--prom",
                        str(prom)]) == 0
    out = capsys.readouterr().out
    assert "Byte economy" in out and "Straggler timeline" in out
    assert csv.read_text().count("\n") == 3
    assert "feddd_rounds_total" in prom.read_text()
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"event": "round"}\n')
    with pytest.raises(ValueError, match="run_start"):
        report.main([str(bad)])


def test_registry_totals_match_the_history():
    reg = obs.MetricsRegistry()
    res = _run("engine", obs.ObsConfig(registry=reg), rounds=2)
    assert reg.value("feddd_uploaded_bytes_total") == sum(
        r.uploaded_bytes for r in res.history)
    assert reg.value("feddd_wire_bytes_total") == sum(
        r.wire_bytes for r in res.history)
    assert reg.value("feddd_rounds_total", scheme="feddd",
                     path="engine") == 2


def test_default_obs_config_is_inert():
    assert not obs.ObsConfig().active
    assert obs.make_recorder(obs.ObsConfig(), driver="x") is \
        obs.NULL_RECORDER
    assert obs.make_recorder(None, driver="x") is obs.NULL_RECORDER
    for kw in (dict(enabled=True), dict(jsonl_path="x.jsonl"),
               dict(trace=True), dict(registry=obs.MetricsRegistry())):
        assert obs.ObsConfig(**kw).active
    with obs.NULL_RECORDER.span("phase"):
        pass
    obs.NULL_RECORDER.event("x", kind="y")
    obs.NULL_RECORDER.close()
    tel, ltf, _ = _quickstart_pieces(synthetic, partition, heterogeneity,
                                     models, device="cpu")
    srv = protocol.FedDDServer(convert.to_torch(_jax_params(), "cpu"),
                               protocol.ProtocolConfig(rounds=1), tel,
                               device="cpu")
    srv.run(ltf)
    assert srv.obs is obs.NULL_RECORDER


def _feed(reg):
    reg.describe("lat_seconds", "histogram", "request latency",
                 buckets=(0.01, 0.1, 1.0))
    for v in (0.002, 0.05, 0.05, 0.7, 3.0):
        reg.observe("lat_seconds", v, route="a")
    reg.observe("lat_seconds", 0.2, route="b")
    reg.observe("span_seconds", 1e-4, name="encode")
    reg.inc("req_total", 1, path="a", scheme="feddd")
    reg.inc("req_total", 2.5, path="a", scheme="feddd")
    reg.inc("req_total", 7, path="b", scheme="oort")
    reg.set("temp", 3.25, room="x")
    reg.set("temp", 1e-17, room="y")
    reg.set("rounds_per_sec", 12.0)


def test_metrics_registry_renders_like_the_jax_registry():
    ours, theirs = obs.MetricsRegistry(), jax_metrics.MetricsRegistry()
    _feed(ours)
    _feed(theirs)
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert ours.csv_rows() == theirs.csv_rows()
    assert ours.csv_rows(header=False) == theirs.csv_rows(header=False)
    assert ours.samples() == theirs.samples()
    assert ours.value("req_total", path="a", scheme="feddd") == 3.5
    with pytest.raises(ValueError):
        ours.inc("req_total", -1)
    with pytest.raises(ValueError):
        ours.set("req_total", 1.0)


def _step_inputs():
    from repro_torch.core.round_engine import stack_pytrees
    from repro_torch.fl import MLP_SPEC, init_cnn_spec
    rng = np.random.default_rng(0)
    gp = init_cnn_spec(MLP_SPEC, device="cpu")
    old = stack_pytrees([gp] * 3)
    new = tree.tree_map(lambda x: x + torch.from_numpy(
        rng.normal(0, 0.02, x.shape).astype(np.float32)), old)
    return old, new, gp


def test_engine_scopes_appear_only_under_a_profiler():
    from repro_torch.core.round_engine import BatchedRoundEngine
    old, new, gp = _step_inputs()
    engine = BatchedRoundEngine()
    assert isinstance(obs.profiler_scope("x"), contextlib.nullcontext)
    plain = engine.step(old, new, gp, [0.2, 0.5, 0.0], [1.0, 2.0, 3.0],
                        full_round=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = engine.step(old, new, gp, [0.2, 0.5, 0.0],
                             [1.0, 2.0, 3.0], full_round=False)
    names = {e.key for e in prof.key_averages()}
    assert {"feddd_encode_masks", "feddd_encode_wire", "feddd_aggregate",
            "feddd_client_update"} <= names
    for a, b in zip(tree.leaves(traced.client_params),
                    tree.leaves(plain.client_params)):
        assert torch.equal(a, b)


def test_trace_spans_enter_record_function():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run("engine", obs.ObsConfig(trace=True), rounds=1)
    names = {e.key for e in prof.key_averages()}
    assert ENGINE_SPANS <= names
