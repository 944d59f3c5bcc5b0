"""The traced recorder's span fields (``repro_torch.obs.recorder``) on the
CPU: spans on the profiler trace's clock, the sync counter's charges, the
device times anchored at the round's copy, the untraced path left as it
was, and the log of a run that raises.

The CUDA parts run here against stand-ins for ``torch.cuda.Event`` and
the sync debug mode; ``tests/test_torch_cuda.py`` runs them on a card.
"""

import inspect
import json
import time
import types
import warnings

import pytest
import torch

from repro_torch import obs, prng
from repro_torch.core import protocol
from repro_torch.data import make_dataset, partition_noniid_b
from repro_torch.fl import MLP_SPEC, heterogeneity, init_cnn_spec, models
from repro_torch.obs import recorder, report

CUDA = torch.device("cuda")


def _run(cfg_obs, rounds=2, ltf_wrap=None, scheme="feddd", **kw):
    """Engine rounds (``batched=False``: the loop's) of the paper's MLP
    over 5 clients at a tiny size."""
    train, _ = make_dataset("mnist", num_train=500, num_test=10)
    parts = partition_noniid_b(train, 5, seed=0)
    params = init_cnn_spec(MLP_SPEC, prng.PRNGKey(0), device="cpu")
    tel = heterogeneity.sample_system_telemetry(
        5, [341_656] * 5, [len(p) for p in parts],
        [1.0] * 5, seed=0)
    ltf = models.make_local_train_fn(MLP_SPEC, train, parts, flatten=True,
                                     lr=0.1, device="cpu")
    if ltf_wrap is not None:
        ltf = ltf_wrap(ltf)
    return protocol.run_scheme(scheme, params, tel, ltf, None,
                               rounds=rounds, a_server=0.6, h=5, seed=0,
                               device="cpu", obs=cfg_obs, **kw)


class FakeEvent:
    """``torch.cuda.Event`` on a device that, while ``busy``, reaches each
    event ``LAG_NS`` after the host records it, and at once when idle."""
    LAG_NS = 3_000_000
    busy = True
    created = 0
    waits = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).created += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.time_ns() + (self.LAG_NS if self.busy else 0)

    def query(self):
        return self.t <= time.time_ns()

    def synchronize(self):
        type(self).waits += 1
        while not self.query():
            time.sleep(1e-4)

    def elapsed_time(self, end):
        if not (self.query() and end.query()):
            raise RuntimeError("cudaErrorNotReady")
        return (end.t - self.t) * 1e-6


@pytest.fixture
def fake_cuda(monkeypatch):
    """Stand-ins for the CUDA calls the traced recorder makes; returns
    the sync debug modes set, in order."""
    modes = []
    monkeypatch.setattr(FakeEvent, "created", 0)
    monkeypatch.setattr(FakeEvent, "waits", 0)
    monkeypatch.setattr(FakeEvent, "busy", True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    return modes


def _record(t):
    return protocol.RoundRecord(round=t, sim_time=float(t),
                                host_wall_time=0.1, mean_loss=1.0,
                                dropout_rates=[0.0, 0.5],
                                uploaded_fraction=1.0, participants=2)


class Syncing:
    """A value whose host read torch's sync debug mode would report."""

    def __float__(self):
        warnings.warn(recorder.SYNC_WARNING + " (Triggered internally)",
                      UserWarning)
        return 1.0


def _host_float_line():
    lines, first = inspect.getsourcelines(protocol._host_float)
    return first + next(i for i, ln in enumerate(lines) if "return" in ln)


def test_traced_spans_sit_on_the_profiler_clock(tmp_path):
    log = tmp_path / "run.jsonl"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(obs.ObsConfig(trace=True, jsonl_path=str(log)))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = trace["baseTimeNanoseconds"]
    ranges = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
            start = base + round(float(ev["ts"]) * 1e3)
            ranges.setdefault(ev["name"], []).append(
                (start, start + round(float(ev["dur"]) * 1e3)))
    events = obs.read_events(str(log))
    clock = events[0]["clock"]
    assert set(clock) == {"perf_counter_ns", "trace_ns"}
    spans = [e for e in events if e["event"] == "span"]
    assert {e["name"] for e in spans} == {"local_train", "engine_step",
                                          "host_transfer", "allocate"}
    for name, got in ranges.items():
        if name in {e["name"] for e in spans}:
            assert len(got) == sum(e["name"] == name for e in spans)
    seen = {}
    for e in spans:
        s, t = ranges[e["name"]][seen.setdefault(e["name"], 0)]
        seen[e["name"]] += 1
        assert abs(e["host_ns"][0] - s) <= 2e6 and abs(e["host_ns"][1] - t) \
            <= 2e6, (e, s, t)
        # t_start converts to the trace clock by run_start's pair
        assert abs(clock["trace_ns"] + e["t_start"] * 1e9
                   - e["host_ns"][0]) <= 2e6
        assert e["device_ns"] is None
        assert "syncs" not in e     # no CUDA device: nothing counted
        assert e["host_ns"][0] <= e["host_ns"][1]


def test_syncs_are_charged_to_the_innermost_span_and_the_caller(
        tmp_path, fake_cuda):
    log = tmp_path / "run.jsonl"
    filters, shown = list(warnings.filters), warnings.showwarning
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rec = obs.Recorder(obs.ObsConfig(trace=True, jsonl_path=str(log)),
                           driver="test", device=CUDA)
        assert fake_cuda == ["warn"]
        with rec.span("outer", round=1):
            protocol._host_float(Syncing())
            with rec.span("inner", round=1):
                protocol._host_float(Syncing())
                protocol._host_float(Syncing())
        protocol._host_float(Syncing())           # outside every span
        warnings.warn("another warning", RuntimeWarning)
        rec.round(_record(1))
        with rec.span("outer", round=2):
            pass
        rec.close()
    assert fake_cuda == ["warn", 0]
    assert warnings.filters == filters and warnings.showwarning is shown
    # the syncs are counted and shown nowhere; other warnings pass through
    assert [str(w.message) for w in caught] == ["another warning"]
    events = obs.read_events(str(log))
    spans = [e for e in events if e["event"] == "span"]
    assert [(e["name"], e["round"], e["syncs"]) for e in spans] == [
        ("inner", 1, 2), ("outer", 1, 1), ("outside_spans", 1, 1),
        ("outer", 2, 0)]
    site = f"repro_torch/core/protocol.py:{_host_float_line()}"
    assert events[-1]["event"] == "run_end"
    assert events[-1]["sync_sites"] == {site: 4}
    # the report's Prometheus replay exports them by span
    reg = report.registry_from_events(events)
    assert reg.value("feddd_device_syncs_total", span="inner") == 2
    assert reg.value("feddd_device_syncs_total", span="outer") == 1
    assert reg.value("feddd_device_syncs_total",
                     span=recorder.OUTSIDE_SPANS) == 1
    total = sum(v for name, _, v in reg.samples()
                if name == "feddd_device_syncs_total")
    assert sum(e["syncs"] for e in spans) == total == 4


def test_device_times_anchor_after_the_copy_and_wait_only_at_close(
        tmp_path, fake_cuda):
    log = tmp_path / "run.jsonl"
    lag = FakeEvent.LAG_NS
    rec = obs.Recorder(obs.ObsConfig(trace=True, jsonl_path=str(log)),
                       driver="test", device=CUDA)

    def drain(seconds):
        """A blocking copy: it returns once the device has drained."""
        time.sleep(seconds)
        FakeEvent.busy = False
        return "host"

    with rec.span("local_train", round=1):
        time.sleep(1e-3)
    with rec.span("host_transfer", round=1):
        assert rec.to_host(drain, 2 * lag * 1e-9) == "host"
    with rec.span("allocate", round=1):
        pass
    rec.round(_record(1))
    assert rec._pending == [] and FakeEvent.waits == 0
    with rec.span("local_train", round=2):
        FakeEvent.busy = True           # work launched: the device lags
    rec.round(_record(2))
    # the span's exit is still pending: carried, not awaited
    assert len(rec._pending) == 1 and FakeEvent.waits == 0
    rec.close()
    assert FakeEvent.waits == 3         # the anchor and the span's events
    spans = [e for e in obs.read_events(str(log)) if e["event"] == "span"]
    assert [e["name"] for e in spans] == ["local_train", "host_transfer",
                                          "allocate", "local_train"]
    # the device reached each event LAG_NS after the host's reading while
    # busy, at once while idle; the anchor's reading precedes its record
    # by the microseconds the recorder takes between them
    want = [(lag, lag), (lag, 0), (0, 0), (0, lag)]
    for e, lags in zip(spans, want):
        for host, dev, late in zip(e["host_ns"], e["device_ns"], lags):
            assert late - 1e5 <= dev - host <= late + 1e6, (e, lags)
    # events are recycled once resolved
    assert FakeEvent.created <= 2 * len(spans) + 2


def test_the_anchor_the_device_took_soonest_sets_the_times(tmp_path,
                                                          fake_cuda):
    """An anchor whose record the device took late (here by LAG_NS) bounds
    the device timer loosely; a later one taken at once sets the times."""
    log = tmp_path / "run.jsonl"
    lag = FakeEvent.LAG_NS
    rec = obs.Recorder(obs.ObsConfig(trace=True, jsonl_path=str(log)),
                       driver="test", device=CUDA)

    def copy(busy_after):
        time.sleep(2 * lag * 1e-9)
        FakeEvent.busy = busy_after

    rec.to_host(copy, True)             # its anchor lags
    FakeEvent.busy = False
    time.sleep(2 * lag * 1e-9)
    with rec.span("allocate", round=1):
        pass
    rec.round(_record(1))
    rec.to_host(copy, False)            # its anchor is taken at once
    with rec.span("allocate", round=2):
        pass
    rec.round(_record(2))
    rec.close()
    late, timely = [e for e in obs.read_events(str(log))
                    if e["event"] == "span"]
    # alone, the late anchor puts the device LAG_NS early ...
    for host, dev in zip(late["host_ns"], late["device_ns"]):
        assert -lag - 1e6 <= dev - host <= -lag + 1e5
    # ... and the timely one puts it right
    for host, dev in zip(timely["host_ns"], timely["device_ns"]):
        assert -1e5 <= dev - host <= 1e6


def test_a_copy_that_leaves_work_queued_sets_no_anchor(fake_cuda):
    rec = obs.Recorder(obs.ObsConfig(trace=True), driver="test",
                       device=CUDA)
    assert rec.to_host(lambda: "host") == "host"    # returned at once
    assert not rec._anchors
    rec.close()


def test_trace_off_creates_no_event_and_leaves_the_sync_mode(
        tmp_path, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("CUDA called with trace off")

    for name in ("Event", "set_sync_debug_mode", "get_sync_debug_mode",
                 "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    filters, shown = list(warnings.filters), warnings.showwarning
    log = tmp_path / "run.jsonl"
    _run(obs.ObsConfig(enabled=True, jsonl_path=str(log)))
    rec = obs.Recorder(obs.ObsConfig(jsonl_path=str(tmp_path / "r.jsonl")),
                       driver="test", device=CUDA)
    with rec.span("local_train", round=1):
        with rec.span("engine_step", round=1):
            rec.to_host(float, torch.ones(()))
    rec.round(_record(1))
    rec.close()
    assert warnings.filters == filters and warnings.showwarning is shown
    for path in (log, tmp_path / "r.jsonl"):
        events = obs.read_events(str(path))
        assert "clock" not in events[0] and "sync_sites" not in events[-1]
        for e in events:
            if e["event"] == "span":
                assert set(e) <= {"event", "name", "t_start", "dur_s",
                                  "round"}


def test_a_run_that_raises_still_writes_its_log(tmp_path):
    log = tmp_path / "run.jsonl"

    def failing(ltf):
        calls = []

        def train(params, i, key):
            calls.append(i)
            if len(calls) > 5:          # the second round's first client
                raise RuntimeError("client lost")
            return ltf(params, i, key)
        return train

    with pytest.raises(RuntimeError, match="client lost"):
        _run(obs.ObsConfig(trace=True, jsonl_path=str(log)), rounds=3,
             ltf_wrap=failing)
    events = obs.read_events(str(log))
    assert [e["event"] for e in events if e["event"] != "span"] == [
        "run_start", "round", "run_end"]
    assert len(obs.load_history(str(log))) == 1


def test_the_hooks_come_off_when_a_traced_run_raises(tmp_path, fake_cuda):
    filters, shown = list(warnings.filters), warnings.showwarning
    rec = obs.Recorder(obs.ObsConfig(trace=True,
                                     jsonl_path=str(tmp_path / "r.jsonl")),
                       driver="test", device=CUDA)
    with pytest.raises(ValueError):
        try:
            with rec.span("local_train", round=1):
                raise ValueError("trainer failed")
        finally:
            rec.close()
    assert fake_cuda == ["warn", 0]
    assert warnings.filters == filters and warnings.showwarning is shown
    assert rec._open == []
    assert obs.read_events(str(tmp_path / "r.jsonl"))[-1]["event"] == \
        "run_end"


def test_null_recorder_copies_through():
    assert obs.NULL_RECORDER.to_host(lambda a, b: a + b, 2, 3) == 5
    ns = types.SimpleNamespace(calls=0)

    def copy():
        ns.calls += 1
        return "host"

    rec = obs.Recorder(obs.ObsConfig(trace=True), driver="test",
                       device=torch.device("cpu"))
    assert rec.to_host(copy) == "host" and ns.calls == 1
    assert not rec._anchors
    rec.close()


def test_the_loop_anchors_at_its_loss_reads(tmp_path, fake_cuda,
                                            monkeypatch):
    """FedAvg on the per-client loop copies only its clients' losses; the
    recorder anchors there, so every span gets device times and nothing
    is left pending at a round's end."""
    make = obs.make_recorder
    monkeypatch.setattr(protocol.obs_mod, "make_recorder",
                        lambda cfg, **kw: make(cfg, **{**kw, "device": CUDA}))
    FakeEvent.busy = False
    pending = []
    round_ = obs.Recorder.round

    def round_and_look(self, record, **kw):
        round_(self, record, **kw)
        pending.append(len(self._pending))

    monkeypatch.setattr(obs.Recorder, "round", round_and_look)
    log = tmp_path / "run.jsonl"
    _run(obs.ObsConfig(trace=True, jsonl_path=str(log)), scheme="fedavg",
         batched=False)
    assert pending == [0, 0]
    spans = [e for e in obs.read_events(str(log)) if e["event"] == "span"]
    assert {e["name"] for e in spans} == {"local_train", "encode",
                                          "aggregate", "client_update"}
    assert all(e["device_ns"] is not None for e in spans)


def test_spans_without_a_copy_keep_no_events(fake_cuda):
    """A path that never copies through the recorder sets no anchor: its
    spans' events are dropped at each round, not held for the run."""
    rec = obs.Recorder(obs.ObsConfig(trace=True), driver="test",
                       device=CUDA)
    for t in (1, 2, 3):
        with rec.span("local_train", round=t):
            pass
        rec.round(_record(t))
        assert rec._pending == []
    rec.close()
    assert FakeEvent.waits == 0


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
def test_the_log_reaches_the_file_as_the_writer_says(tmp_path, trace):
    """Untraced, each event is on disk when it is written (a killed run
    keeps its early rounds); traced, the file is written at close, and
    is not opened, nor truncated, before."""
    log = tmp_path / "run.jsonl"
    log.write_text("an older log\n")
    rec = obs.Recorder(obs.ObsConfig(trace=trace, jsonl_path=str(log)),
                       driver="test", device=torch.device("cpu"))
    with rec.span("allocate", round=1):
        pass
    rec.round(_record(1))
    if trace:
        assert log.read_text() == "an older log\n"
    else:
        assert [e["event"] for e in obs.read_events(str(log))] == [
            "run_start", "span", "round"]
    rec.close()
    assert [e["event"] for e in obs.read_events(str(log))] == [
        "run_start", "span", "round", "run_end"]
