"""Whole runs of the harness on the CPU at tiny sizes: the reference
agrees with the port; the harness reports ``correct`` false when the
timed path is broken underneath, and when the control (the reference in
TF32, in the program's place) stands in for the program."""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import control, harness, inputs, lookup, program, tracing

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
# a tiny fleet: 3 clients, 2 minibatches a round, the full broadcast at
# round 2 and the checked round after it
TINY = {"clients": 3, "samples_per_client": 20, "batch": 10, "h": 2,
        "check_rounds": 3, "trace_after_rounds": 1, "trace_rounds": 1}
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell="cnn2.c100.fused", traffic=TINY, trace=False):
    return harness.run_cell(ROOT, cell, SEED, 0.05, trace, device=CPU,
                            t_start=time.perf_counter(),
                            log=lambda s: None, traffic_overrides=traffic)


@pytest.mark.parametrize("cell_name", ["cnn2.c100.fused"], ids=["fused"])
def test_port_agrees_with_reference(cell_name):
    cell = harness.load_cell(ROOT, cell_name, TINY)
    res = _run(cell_name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.metrics(False)}
    assert list(res)[-1] == "checks"


def test_traced_run_reads_spans_and_window():
    res = _run(trace=True)
    assert res["correct"]
    assert res["metrics"]["allocate_ms"]["value"] > 0
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def _shift_first_rate(orig):
    def solve(*a, **kw):
        out = orig(*a, **kw)
        d = np.array(out.dropout_rates, float)
        d[0] += -0.05 if d[0] >= 0.05 else 0.05
        return dataclasses.replace(out, dropout_rates=d)
    return solve


def _unchanged_step(orig):
    def step(self, stacked_old, stacked_new, global_params, *a, **kw):
        out = orig(self, stacked_old, stacked_new, global_params, *a, **kw)
        return out._replace(client_params=stacked_old,
                            global_params=global_params)
    return step


def _half_batch(orig):
    def ce(logits, y):
        n = y.shape[0] // 2
        return orig(logits[:n], y[:n])
    return ce


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "rates"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.core import protocol, round_engine
    from repro_torch.fl import models
    if fault == "unchanged":
        monkeypatch.setattr(round_engine.BatchedRoundEngine, "step",
                            _unchanged_step(round_engine.BatchedRoundEngine
                                            .step))
    elif fault == "half_batch":
        monkeypatch.setattr(models, "_ce", _half_batch(models._ce))
    else:
        monkeypatch.setattr(protocol, "solve_dropout_rates_with",
                            _shift_first_rate(
                                protocol.solve_dropout_rates_with))
    assert not _run()["correct"]


def test_control_is_not_correct():
    cell = harness.load_cell(ROOT, "cnn2.c100.fused", TINY)
    values = control.readings(cell, SEED, "tf32", CPU)
    assert not all(values[k] <= v for k, v in cell.limits.items()), values


def test_round_ends_come_from_the_record_stream():
    """The program calls the harness once a round, as each round's record
    reaches its observability, and an exception raised there ends the
    run after that round."""
    cell = harness.load_cell(ROOT, "cnn2.c100.fused", TINY)
    prog = program.build(cell.cfg, cell.traffic,
                         inputs.make_inputs(cell.cfg, cell.traffic, SEED, CPU))
    seen = []
    res = prog.run(3, lambda: seen.append(len(seen)))
    assert seen == [0, 1, 2] and len(res.history) == 3

    class Stop(Exception):
        pass

    def stop_at_two():
        seen.append(len(seen))
        if len(seen) == 5:
            raise Stop
    with pytest.raises(Stop):
        prog.run(10, stop_at_two)
    assert len(seen) == 5 and prog.stream.on_round is None


@pytest.mark.parametrize("kind,key", [("labels", "labels"),
                                      ("fleets", "fleet"),
                                      ("trainers", "trainer")])
def test_traffic_pieces_resolve_by_name(kind, key):
    traffic = harness.load_cell(ROOT, "cnn2.c100.fused").traffic
    mod = lookup.module(kind, traffic[key])
    assert mod is lookup.module(kind, traffic[key])
    with pytest.raises(ValueError):
        lookup.module(kind, "no-such-piece")


def test_profiler_records_only_user_ranges(tmp_path):
    """The traced run's session keeps the ``record_function`` ranges and
    leaves out the ATen operators, whose recording would slow the host."""
    prof = tracing.profiler(CPU)
    prof.start()
    x = torch.ones(8, 8)
    with torch.profiler.record_function(tracing.WINDOW):
        for _ in range(50):
            x = x @ x / 8
    prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    cats = {str(e.get("cat")) for e in events if e.get("ph") == "X"}
    assert "user_annotation" in cats and "cpu_op" not in cats
    trace = tracing.load(str(path), 1)
    assert trace is not None and trace.window_s > 0


def test_run_imports_no_jax():
    """A run of the program on the CPU loads neither JAX nor the JAX
    package (whole top-level names: ``repro_torch`` is not ``repro``)."""
    code = (
        "import sys, time, torch; from pathlib import Path;"
        "torch.set_num_threads(2);"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}];"
        "from perfbench import harness;"
        f"harness.run_cell(Path({str(ROOT)!r}), 'cnn2.c100.fused', 1, 0.01,"
        " False, device=torch.device('cpu'), t_start=time.perf_counter(),"
        f" log=lambda s: None, traffic_overrides={TINY!r});"
        "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_inputs_come_from_the_seed():
    """The same seed, even one past 32 bits, gives the same inputs; another
    seed other pixels and weights, but the same amount of work."""
    cell = harness.load_cell(ROOT, "cnn2.c100.fused", TINY)
    a, b, c = (inputs.make_inputs(cell.cfg, cell.traffic, s, CPU)
               for s in (2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2))
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    assert torch.equal(a.global_params["fc5"]["w"],
                       b.global_params["fc5"]["w"])
    assert a.protocol_seed == b.protocol_seed
    for k, v in a.telemetry.items():
        assert np.array_equal(v, b.telemetry[k]), k
    assert not torch.equal(a.x, c.x) and a.x.shape == c.x.shape
