"""One run of one cell: set-up, the measured window, the check, the
metrics.  Everything cell-specific is data found by name:

* ``BENCHMARK.json`` maps the cell to its configuration and traffic and
  lists the metrics;
* ``perfbench/configs/<config>.json``: the model specs and the data;
* ``perfbench/traffic/<traffic>.json``: the fleet, its labels, its
  trainer and its reference (each a module found by name, see
  ``perfbench.lookup``), the training and the FedDD settings;
* ``perfbench/limits/<cell>.json``: the limit of each number compared;
* ``perfbench/metrics/<metric>.py``: a reader, ``read(run)``, that
  returns the metric's value from a :class:`RunData`, or None where it
  finds nothing to read.

The run: make the inputs from the seed; build the program's server and
trainer; drive it through its first h + 1 rounds (they warm up every
shape the window uses, the full-broadcast round h among them) and keep
what they produced; then measure rounds of the same server for
``seconds``, each round ending when its record reached the program's
observability (its telemetry on the host, the LP run); with ``trace`` a
stretch of those rounds is profiled.  After the window the
peak memory is read, the program is freed, and the reference checks the
first rounds (``perfbench.compare``) to decide ``correct``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import compare, flops, hardware, inputs as inputs_mod
from perfbench import lookup, program as program_mod, tracing

HERE = Path(__file__).resolve().parent
# host ranges the idle gaps are named by (the program's spans and scopes)
HOST_RANGES = ("local_train", "engine_step", "host_transfer", "allocate",
               "eval", "feddd_encode_masks", "feddd_encode_wire",
               "feddd_aggregate", "feddd_client_update")


class WindowClosed(Exception):
    """Raised from the per-round hook to end ``FedDDServer.run``."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]

    def metrics(self, trace: bool) -> List[Dict]:
        return [m for m in (self.per_layer if trace else self.end_to_end)
                if self.name in m.get("workloads", [self.name])]


def load_cell(root: Path, name: str, traffic_overrides=None) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json; ``traffic_overrides``
    replace traffic parameters (the tests' small fleets)."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"unknown workload {name!r}")
    conf = next(c for c in manifest["configs"] if c["name"] == wl["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json")
                         .read_text())
    traffic.update(traffic_overrides or {})
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return Cell(name, wl["chips"], cfg, traffic, limits["limits"],
                manifest["end_to_end"], manifest["per_layer"])


def reader(metric: str) -> Callable:
    """``read`` of ``perfbench/metrics/<metric>.py``."""
    return lookup.module("metrics", metric).read


def reference(traffic: Dict):
    """The plain reference the traffic names: ``perfbench/reference/
    <reference>.py``, with ``run_rounds`` and ``round_from``."""
    return importlib.import_module(f"perfbench.reference."
                                   f"{traffic['reference']}")


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""
    cfg: Dict
    traffic: Dict
    client_spec: List[int]
    setup_s: float
    round_s: List[float]             # each window round's duration
    window_s: float                  # the window, ending in a sync
    flops_per_round: int
    peaks: Dict[str, float]
    trace: Optional[tracing.Trace] = None
    spans: Optional[List[Dict]] = None
    traced_round_ids: List[int] = dataclasses.field(default_factory=list)

    def leaves(self):
        """{layer: {key: shape}} of the global spec: the model every
        client of a homogeneous fleet holds."""
        return inputs_mod.leaf_shapes(
            self.cfg["specs"][self.cfg["global_spec"]])

    def client_leaves(self):
        """Each client's {layer: {key: shape}}, from its own spec (a
        ragged fleet's clients hold sub-models of the global one)."""
        shapes = [inputs_mod.leaf_shapes(s) for s in self.cfg["specs"]]
        return [shapes[j] for j in self.client_spec]

    @property
    def clients(self) -> int:
        return len(self.client_spec)

    def partial_traced_rounds(self) -> int:
        """Traced rounds with ``t mod h != 0`` (Eq. (5), not Eq. (6))."""
        return sum(t % self.traffic["h"] != 0 for t in self.traced_round_ids)


def _cpu_copy(params: Dict) -> Dict:
    return {n: {k: t.detach().to("cpu", copy=True) for k, t in lay.items()}
            for n, lay in params.items()}


def pristine(inp: inputs_mod.Inputs) -> inputs_mod.Inputs:
    """A copy of the inputs the program cannot reach: the reference's."""
    g = {n: {k: t.clone() for k, t in lay.items()}
         for n, lay in inp.global_params.items()}
    if all(p is inp.global_params for p in inp.client_params):
        clients = [g] * len(inp.client_params)
    else:
        clients = [{n: {k: t.clone() for k, t in lay.items()}
                    for n, lay in p.items()} for p in inp.client_params]
    return dataclasses.replace(inp, global_params=g, client_params=clients)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def checked_rounds(prog, traffic: Dict):
    """The program's first h + 1 rounds through its own entry, from the
    seed: the first full broadcast (t = h) and the round after it."""
    rounds = traffic["check_rounds"]
    if rounds != traffic["h"] + 1:
        raise ValueError("check_rounds must be h + 1")
    globals_: List[Dict] = []
    res = prog.run(rounds,
                   lambda: globals_.append(_cpu_copy(prog.state()[0])))
    return reference(traffic).Rounds(
        [r.mean_loss for r in res.history],
        [np.asarray(r.dropout_rates, float) for r in res.history],
        [r.uploaded_fraction for r in res.history], globals_,
        [_cpu_copy(p) for p in prog.state()[1]])


def check(cfg: Dict, traffic: Dict, ref_inputs, snap) -> Dict[str, float]:
    """The numbers ``perfbench.compare`` holds to the limits: the
    reference's round 1 from the seed and its round h + 1 from the
    program's state after round h, both computed in float64, so that
    the gaps read the program's own round-off."""
    ref = reference(traffic)
    first = ref.run_rounds(cfg, traffic, ref_inputs, 1, precision="fp64")
    after = ref.round_from(cfg, traffic, ref_inputs, len(snap.mean_loss),
                           snap.globals[-2], snap.rates[-2],
                           precision="fp64")
    return compare.numbers(snap, first, after, ref_inputs.global_params)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             *, device: torch.device, t_start: float,
             log: Callable[[str], None] = print,
             traffic_overrides=None) -> Dict:
    """One run of cell ``name`` -> the result line's object."""
    return run(load_cell(root, name, traffic_overrides), seed, seconds,
               trace, device=device, t_start=t_start, log=log)


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        device: torch.device, t_start: float,
        log: Callable[[str], None] = print) -> Dict:
    """One run of ``cell`` -> the result line's object."""
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-"))
    try:
        return _run(cell, seed, seconds, trace, device, t_start, tmp, log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell: Cell, seed: int, seconds: float, trace: bool,
         device: torch.device, t_start: float, tmp: Path, log) -> Dict:
    cfg, traffic = cell.cfg, cell.traffic
    inp = inputs_mod.make_inputs(cfg, traffic, seed, device)
    ref_inputs = pristine(inp)
    jsonl = str(tmp / "obs.jsonl")
    prog = program_mod.build(cfg, traffic, inp, jsonl if trace else None)

    snap = checked_rounds(prog, traffic)
    executor = prog.executor_kind()

    # the window
    profiler = tracing.profiler(device) if trace else None
    trace_from = traffic["trace_after_rounds"]
    trace_to = trace_from + traffic["trace_rounds"]
    marks: List[float] = []
    window_range = []
    # the set-up's objects out of the collector's way: a collection of them
    # inside the window would be a pause of the harness's making
    gc.collect()
    gc.freeze()
    _sync(device)
    spans_before = prog.host_span_seconds()
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()

    def window_round():
        marks.append(time.perf_counter())
        k = len(marks)
        if profiler is not None:
            if k == trace_from:
                profiler.start()
                window_range.append(
                    torch.autograd.profiler.record_function(tracing.WINDOW))
                window_range[0].__enter__()
            elif k == trace_to:
                _sync(device)
                window_range[0].__exit__(None, None, None)
                profiler.stop()
        done = profiler is None or k >= trace_to
        if done and marks[-1] - t0 >= seconds:
            raise WindowClosed

    try:
        prog.run(10 ** 9, window_round)
    except WindowClosed:
        pass
    _sync(device)
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    ends = [t0] + marks
    round_s = [b - a for a, b in zip(ends, ends[1:])]
    host_spans = {k: (v - spans_before.get(k, 0.0)) / len(round_s)
                  for k, v in prog.host_span_seconds().items()}
    final_global = prog.state()[0]
    finite = all(bool(torch.isfinite(t).all()) for lay in
                 final_global.values() for t in lay.values())
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    spans = program_mod.read_spans(jsonl) if trace else None
    del prog, final_global, inp
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # correct: the reference from the same inputs
    t_check = time.perf_counter()
    values = check(cfg, traffic, ref_inputs, snap)
    correct = finite and compare.verdict(values, cell.limits)
    check_s = time.perf_counter() - t_check

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    run = RunData(cfg, traffic, ref_inputs.client_spec, setup_s, round_s,
                  window_s, flops.train_flops_per_round(
                      cfg, traffic, ref_inputs.client_spec),
                  hardware.peaks(kind), spans=spans)
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": kind, "count": cell.chips,
                "memory_peak_bytes": int(peak)}
    breakdown = None
    if profiler is not None:
        path = tmp / "trace.json"
        profiler.export_chrome_trace(str(path))
        run.trace = tracing.load(str(path), traffic["trace_rounds"])
        run.traced_round_ids = list(range(trace_from + 1, trace_to + 1))
        if run.trace is not None:
            dev_info["busy_s"] = run.trace.busy_s()
            dev_info["window_s"] = run.trace.window_s
            breakdown = {
                "device_ops": run.trace.device_ops_top(),
                "idle_gaps": run.trace.idle_by_host_range(HOST_RANGES)}
    metrics = {}
    for m in cell.metrics(trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    log(f"perfbench {cell.name} seed {seed}: executor {executor}, "
        f"{len(round_s)} rounds in {window_s:.3f} s (median round "
        f"{float(np.median(round_s)):.4f} s), set-up {setup_s:.3f} s, "
        f"check {check_s:.3f} s, power limit {hardware.power_limit()!r}")
    log("host s a round in the program's spans (enqueue; the device's "
        "wait lands in host_transfer): " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(host_spans.items())))
    log("median round s by tenth of the window: " + " ".join(
        f"{float(np.median(part)):.4f}"
        for part in np.array_split(np.asarray(round_s), 10) if len(part)))
    result = {"correct": bool(correct), "attempted": len(round_s),
              "failed": 0 if finite else len(round_s),
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": values[k], "limit": cell.limits[k]}
                        for k in cell.limits}
    return result


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` the run may not hold: JAX and
    the JAX package (whole names: ``repro_torch`` is not ``repro``)."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)
