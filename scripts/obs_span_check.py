#!/usr/bin/env python3
"""A benchmark cell driven through the benchmark's own pieces (its
inputs, program and profiler), with the program's traced span fields held
against the profiler's trace of the same rounds:

    python3 scripts/obs_span_check.py [--workload cnn2.c100.fused] \\
        [--seed N] [--rounds 120] [--trace 0|1] [--device cuda]

The cell's h + 1 rounds warm up every shape; then ``--rounds`` rounds
run, and with ``--trace 1`` the traffic's ``trace_rounds`` after its
``trace_after_rounds`` are profiled as the benchmark profiles them.  One
JSON line is printed:

* ``round_ms``: the quartiles of the rounds the profiler did not record,
  leaving out the round after them (every round with ``--trace 0``);
* traced: ``host_vs_range_ms``, each span's ``host_ns`` less its
  ``record_function`` range in the profiled rounds (start and end: the
  median and largest absolute gap, and the signed median);
  ``engine_step_end_ms``, the ``engine_step`` span's ``device_ns`` end
  less the end of the last kernel launched inside its range;
  ``cupti_lead_ms``, the least kernel start less launch in each such
  range: the device is drained when the step begins, so this is CUPTI's
  offset from the host clock plus a launch's few microseconds;
  ``engine_step_end_less_lead_ms``, the gap with CUPTI's times moved
  back by that lead; ``sync_sites``, the run's
  synchronising calls by ``file:line`` a round; ``span_metrics``, the
  benchmark's four span readers over the unprofiled rounds.

Made for an NVIDIA card; ``--device cpu`` runs the same steps there,
without device times or syncs.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPAN_METRICS = ("syncs_per_round", "local_train_enqueue_ms",
                "local_train_stream_ms", "host_lead_ms")


def _gaps(xs):
    """Median and largest absolute value of ``xs`` (ms), and the median."""
    a = sorted(abs(x) for x in xs)
    return {"median": statistics.median(a), "max": a[-1],
            "signed_median": statistics.median(xs), "n": len(a)} \
        if a else None


def _base_ns(path: Path) -> int:
    """The Chrome trace's ``baseTimeNanoseconds``: its ``ts`` are
    microseconds after it."""
    return int(re.search(r'"baseTimeNanoseconds":\s*(\d+)',
                         path.read_text()).group(1))


def clock_checks(trace_path: Path, spans, profiled) -> dict:
    """The profiled rounds' spans against the trace: ``host_ns`` against
    the ``record_function`` range nearest its start, and ``engine_step``'s
    ``device_ns`` end against the last kernel launched inside its range,
    as CUPTI times it and moved back by CUPTI's lead in that range."""
    from perfbench import tracing

    trace = tracing.load(str(trace_path), len(profiled))
    base = _base_ns(trace_path)
    ns = lambda us: base + us * 1e3                       # noqa: E731
    starts, ends, step_ends, leads = [], [], [], []
    for e in spans:
        if e.get("round") not in profiled or not e.get("host_ns") \
                or e["name"] not in trace.ranges:
            continue
        s, t = min(((ns(a), ns(b)) for a, b in trace.ranges[e["name"]]),
                   key=lambda r: abs(r[0] - e["host_ns"][0]))
        starts.append((e["host_ns"][0] - s) * 1e-6)
        ends.append((e["host_ns"][1] - t) * 1e-6)
        if e["name"] == "engine_step" and e.get("device_ns"):
            inside = [(k[1] - trace.launch_ts[k[3]], ns(k[2]))
                      for k in trace.kernels if k[3] in trace.launch_ts
                      and s <= ns(trace.launch_ts[k[3]]) <= t]
            if inside:
                step_ends.append((e["device_ns"][1]
                                  - max(end for _, end in inside)) * 1e-6)
                leads.append(min(d for d, _ in inside) * 1e-3)
    return {"host_vs_range_ms": {"start": _gaps(starts), "end": _gaps(ends)},
            "engine_step_end_ms": _gaps(step_ends),
            "cupti_lead_ms": _gaps(leads),
            "engine_step_end_less_lead_ms": _gaps(
                [g + d for g, d in zip(step_ends, leads)])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="cnn2.c100.fused")
    ap.add_argument("--seed", type=int, default=3100000001)
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import hardware, harness, inputs, program, tracing
    from repro_torch.obs import read_events

    device = torch.device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    torch.set_num_threads(1)
    cell = harness.load_cell(ROOT, args.workload)
    traffic = cell.traffic
    first = traffic["trace_after_rounds"]
    last = first + traffic["trace_rounds"]
    tmp = Path(tempfile.mkdtemp(prefix="obs-span-check-"))
    log = tmp / "obs.jsonl"
    prog = program.build(cell.cfg, traffic, inputs.make_inputs(
        cell.cfg, traffic, args.seed, device),
        str(log) if args.trace else None)
    prog.run(traffic["check_rounds"])
    prof = tracing.profiler(device) if args.trace else None
    marks, window = [], []

    def on_round():
        marks.append(time.perf_counter())
        k = len(marks)
        if prof is not None and k == first:
            prof.start()
            window.append(torch.profiler.record_function(tracing.WINDOW))
            window[0].__enter__()
        elif prof is not None and k == last:
            sync()
            window[0].__exit__(None, None, None)
            prof.stop()
        if k == args.rounds:
            raise harness.WindowClosed

    sync()
    t0 = time.perf_counter()
    try:
        prog.run(10 ** 9, on_round)
    except harness.WindowClosed:
        pass
    ends = [t0] + marks
    profiled = set(range(first + 1, last + 1)) if args.trace else set()
    skip = profiled | {last + 1} if args.trace else set()
    rounds = [1e3 * (b - a) for k, (a, b) in
              enumerate(zip(ends, ends[1:]), 1) if k not in skip]
    q = statistics.quantiles(rounds, n=4)
    out = {"obs_span_check": args.workload, "trace": args.trace,
           "seed": args.seed, "card": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "power_limit": hardware.power_limit(), "rounds": len(marks),
           "round_ms": [q[0], statistics.median(rounds), q[2]]}
    if args.trace:
        events = read_events(str(log))
        spans = [e for e in events if e["event"] == "span"]
        prof.export_chrome_trace(str(tmp / "trace.json"))
        out.update(clock_checks(tmp / "trace.json", spans, profiled))
        # every round ran its syncs; the last one stopped the run in
        # its record, before its event reached the log
        out["sync_sites"] = {k: v / len(marks) for k, v in
                             events[-1].get("sync_sites", {}).items()}
        run = types.SimpleNamespace(spans=spans,
                                    traced_round_ids=sorted(profiled))
        out["span_metrics"] = {m: harness.reader(m)(run)
                               for m in SPAN_METRICS}
    for f in tmp.iterdir():
        f.unlink()
    tmp.rmdir()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
