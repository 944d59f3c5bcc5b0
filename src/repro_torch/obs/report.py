"""Run-inspection CLI over a JSONL run log.

::

    python -m repro_torch.obs.report results/quickstart_run.jsonl \
        [--csv report.csv] [--prom metrics.prom] [--top 5]

Renders, from the structured events alone (repro_torch.obs.runlog):

* run header — driver, scheme, fleet, wall/sim seconds, rounds/sec;
* per-phase time breakdown — host span totals (calls, total s, mean ms,
  share of spanned time) for the allocate → train → encode → transport →
  aggregate → eval pipeline;
* byte economy — uploaded vs on-wire totals, wire overhead/savings,
  abandoned + quarantined bytes;
* failure economy — skipped rounds, survivor stats, retries, incident
  counts by kind;
* cohort participation — population-mode runs: how
  many distinct clients the service reached, first contacts per round,
  and a rounds-participated histogram reconstructed from the per-round
  ``cohort`` events;
* straggler timelines — per-client upload-completion offsets (sim clock)
  with mean/max and slowest-in-round counts; ``--top N`` worst clients —
  prefaced by the correlated-outage windows: each
  cell's down intervals reconstructed from outage_begin/outage_end
  incidents, so a burst of slow rounds reads against the cells that
  were dark while it happened.

``--csv`` writes the per-round stream as CSV; ``--prom`` replays the
round + fault events through the SAME
:func:`repro_torch.obs.recorder.update_round_metrics` mapping a live run uses,
into a fresh registry, and writes its Prometheus text — offline and live
exports always agree.
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.runlog import _RECORD_SCALARS, read_events


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:,.1f} {unit}" if unit != "B" else f"{n:,.0f} B"
        n /= 1024.0
    return f"{n:,.1f} GiB"


def _section(title: str) -> List[str]:
    return ["", title, "-" * len(title)]


def _header_lines(events: List[Dict]) -> List[str]:
    head = events[0]
    tail = next((e for e in reversed(events)
                 if e.get("event") == "run_end"), None)
    meta = {k: v for k, v in head.items()
            if k not in ("event", "schema")}
    lines = _section("Run")
    lines.append("  " + "  ".join(f"{k}={v}" for k, v in meta.items()))
    if tail is not None:
        lines.append(f"  rounds={tail.get('rounds')}"
                     f"  wall={tail.get('wall_s', 0.0):.3f}s"
                     f"  sim={tail.get('sim_s', 0.0):.3f}s"
                     f"  rounds/sec={tail.get('rounds_per_sec', 0.0):.2f}")
    else:
        lines.append("  (no run_end event — run truncated?)")
    return lines


def _phase_lines(events: List[Dict]) -> List[str]:
    spans = [e for e in events if e.get("event") == "span"]
    lines = _section("Phase breakdown (host spans)")
    if not spans:
        lines.append("  no span events (log written without spans?)")
        return lines
    agg: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in spans:
        a = agg[e["name"]]
        a[0] += 1
        a[1] += float(e["dur_s"])
    total = sum(a[1] for a in agg.values()) or 1.0
    lines.append(f"  {'phase':<16}{'calls':>7}{'total_s':>10}"
                 f"{'mean_ms':>10}{'share':>8}")
    for name, (calls, tot) in sorted(agg.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {name:<16}{calls:>7}{tot:>10.4f}"
                     f"{1e3 * tot / calls:>10.3f}"
                     f"{100.0 * tot / total:>7.1f}%")
    return lines


def _byte_lines(rounds: List[Dict],
                events: Optional[List[Dict]] = None) -> List[str]:
    lines = _section("Byte economy")
    if not rounds:
        lines.append("  no round events")
        return lines
    up = sum(float(r.get("uploaded_bytes", 0.0)) for r in rounds)
    wire = sum(float(r.get("wire_bytes", 0.0)) for r in rounds)
    aband = sum(float(r.get("abandoned_bytes", 0.0)) for r in rounds)
    quar = sum(float(r.get("quarantined_bytes", 0.0)) for r in rounds)
    lines.append(f"  uploaded (raw payload): {_fmt_bytes(up)}")
    lines.append(f"  on-wire:                {_fmt_bytes(wire)}")
    if up > 0:
        delta = 100.0 * (wire - up) / up
        word = "overhead" if delta >= 0 else "savings"
        lines.append(f"  wire {word}:          {abs(delta):.1f}%")
    lines.append(f"  abandoned (late/aborted): {_fmt_bytes(aband)}")
    lines.append(f"  quarantined (screened):   {_fmt_bytes(quar)}")
    # client-sharded runs: cross-device Eq. (4) collective bytes
    # (repro_torch.comm.payload.account_collective) — the per-link (1-D)
    # saving of the compacted top-K exchange vs a dense psum
    coll = [e for e in (events or [])
            if e.get("event") == "collective"]
    if coll:
        dense = sum(float(e.get("dense", 0.0)) for e in coll)
        moved = sum(float(e.get("wire", 0.0)) for e in coll)
        lines.append(f"  cross-device (collective): {_fmt_bytes(moved)}"
                     f" of {_fmt_bytes(dense)} dense-psum equivalent")
        if dense > 0:
            lines.append(f"  per-link savings:         "
                         f"{100.0 * (1.0 - moved / dense):.1f}%")
    return lines


def _failure_lines(events: List[Dict], rounds: List[Dict]) -> List[str]:
    lines = _section("Failure economy")
    if not rounds:
        lines.append("  no round events")
        return lines
    skipped = sum(1 for r in rounds if r.get("skipped"))
    retries = sum(int(r.get("retries", 0)) for r in rounds)
    surv = [int(r.get("survivors", 0)) for r in rounds]
    part = [int(r.get("participants", 0)) for r in rounds]
    lines.append(f"  rounds: {len(rounds)}  skipped (quorum): {skipped}"
                 f"  retries: {retries}")
    if surv:
        lines.append(f"  survivors: min {min(surv)} / mean "
                     f"{sum(surv) / len(surv):.1f} / of "
                     f"{max(part) if part else 0} participants")
    incidents = [e for e in events if e.get("event") == "fault"]
    if incidents:
        by_kind: Dict[str, int] = defaultdict(int)
        for e in incidents:
            by_kind[e.get("kind", "unknown")] += 1
        kinds = "  ".join(f"{k}={c}" for k, c in sorted(by_kind.items()))
        lines.append(f"  incidents: {kinds}")
    else:
        lines.append("  incidents: none recorded")
    return lines


def _outage_lines(events: List[Dict]) -> List[str]:
    """Correlated-outage windows, reconstructed from
    the outage_begin / outage_end fault incidents: one line per window,
    so straggler offsets can be read against which cells were dark."""
    begins = [e for e in events if e.get("event") == "fault"
              and e.get("kind") == "outage_begin"]
    ends = [e for e in events if e.get("event") == "fault"
            and e.get("kind") == "outage_end"]
    if not begins and not ends:
        return []
    lines = _section("Outage windows (correlated cell failures)")
    open_by_cell: Dict[int, Dict] = {}
    windows = []     # (cell, begin_round, end_round|None, duration|None,
    #                   members)
    for e in sorted(begins + ends, key=lambda e: int(e.get("round", 0))):
        cell = int(e.get("cell", -1))
        if e.get("kind") == "outage_begin":
            open_by_cell[cell] = e
        else:
            b = open_by_cell.pop(cell, None)
            windows.append((cell,
                            int(b["round"]) if b else None,
                            int(e.get("round", 0)),
                            e.get("duration"),
                            e.get("members", [])))
    for cell, b in sorted(open_by_cell.items()):
        windows.append((cell, int(b["round"]), None, None,
                        b.get("members", [])))
    windows.sort(key=lambda w: (w[1] if w[1] is not None else -1, w[0]))
    for cell, b, end, dur, members in windows:
        span = (f"rounds {b}-{end - 1}" if b is not None and end is not None
                else f"round {b}- (still down at end)" if end is None
                else f"-round {end - 1} (down from start of log)")
        dur_s = f"  ({dur} epoch{'s' if dur != 1 else ''} down)" \
            if dur is not None else ""
        mem = ",".join(str(m) for m in members)
        lines.append(f"  cell {cell}: {span}{dur_s}  members {mem}")
    return lines


def _cohort_lines(events: List[Dict]) -> List[str]:
    """Cohort participation (population-mode runs):
    coverage of the population, first contacts per round, and the
    rounds-participated histogram.  Empty when the log holds no
    ``cohort`` events (fleet-mode runs render no section)."""
    cohorts = [e for e in events if e.get("event") == "cohort"]
    if not cohorts:
        return []
    lines = _section("Cohort participation (population mode)")
    pop = int(cohorts[0].get("population", 0))
    sizes = {int(e.get("cohort_size", 0)) for e in cohorts}
    served: set = set()
    participated: Dict[int, int] = defaultdict(int)
    for e in cohorts:
        served.update(int(c) for c in e.get("cohort", []))
        for c in e.get("participated", []):
            participated[int(c)] += 1
    size_s = (str(next(iter(sizes))) if len(sizes) == 1
              else f"{min(sizes)}-{max(sizes)}")
    lines.append(f"  population: {pop}  cohort size: {size_s}"
                 f"  rounds: {len(cohorts)}")
    lines.append(f"  distinct clients served: {len(served)}"
                 f" ({100.0 * len(served) / pop:.1f}% of population)"
                 if pop else f"  distinct clients served: {len(served)}")
    fc = [(int(e.get("round", i)), int(e.get("first_contact", 0)))
          for i, e in enumerate(cohorts)]
    shown = " ".join(f"r{r}={c}" for r, c in fc[:12])
    more = "  ..." if len(fc) > 12 else ""
    lines.append(f"  first contacts/round: total {sum(c for _, c in fc)}"
                 f"  {shown}{more}")
    hist: Dict[int, int] = defaultdict(int)
    for c in participated.values():
        hist[c] += 1
    lines.append("  rounds-participated histogram:")
    for times in sorted(hist):
        lines.append(f"    {times:>3} round{'s' if times != 1 else ''}: "
                     f"{hist[times]} client{'s' if hist[times] != 1 else ''}")
    return lines


def _straggler_lines(rounds: List[Dict], top: int) -> List[str]:
    lines = _section("Straggler timeline (per-client upload offsets)")
    tracked = [r for r in rounds if r.get("client_up")]
    if not tracked:
        lines.append("  no per-client timing in this log")
        return lines
    n = max(len(r["client_up"]) for r in tracked)
    tot = [0.0] * n
    cnt = [0] * n
    mx = [0.0] * n
    slowest = [0] * n
    for r in tracked:
        ups = r["client_up"]
        seen = [(i, float(t)) for i, t in enumerate(ups) if t is not None]
        for i, t in seen:
            tot[i] += t
            cnt[i] += 1
            mx[i] = max(mx[i], t)
        if seen:
            slowest[max(seen, key=lambda it: it[1])[0]] += 1
    stats = [(i, tot[i] / cnt[i], mx[i], slowest[i], cnt[i])
             for i in range(n) if cnt[i]]
    stats.sort(key=lambda s: -s[1])
    lines.append(f"  {len(tracked)} rounds tracked, {len(stats)} clients;"
                 f" slowest {min(top, len(stats))} by mean offset:")
    lines.append(f"  {'client':>8}{'mean_s':>10}{'max_s':>10}"
                 f"{'slowest_in':>12}{'uploads':>9}")
    for i, mean, m, slow, c in stats[:top]:
        lines.append(f"  {i:>8}{mean:>10.4f}{m:>10.4f}{slow:>12}{c:>9}")
    return lines


def render(events: List[Dict], top: int = 5) -> str:
    rounds = [e for e in events if e.get("event") == "round"]
    lines: List[str] = []
    lines += _header_lines(events)
    lines += _phase_lines(events)
    lines += _byte_lines(rounds, events)
    lines += _failure_lines(events, rounds)
    lines += _outage_lines(events)
    lines += _cohort_lines(events)
    lines += _straggler_lines(rounds, top)
    return "\n".join(lines).lstrip("\n") + "\n"


def rounds_csv(events: List[Dict]) -> str:
    """Per-round stream as CSV (the scalar RoundRecord fields)."""
    cols = list(_RECORD_SCALARS)
    rows = [",".join(cols)]
    for e in events:
        if e.get("event") != "round":
            continue
        rows.append(",".join(repr(e.get(c, "")) if isinstance(e.get(c), float)
                             else str(e.get(c, "")) for c in cols))
    return "\n".join(rows) + "\n"


def registry_from_events(events: List[Dict]) -> MetricsRegistry:
    """Replay round + fault events into a fresh registry via the SAME
    mapping a live Recorder uses (update_round_metrics), and a traced
    CUDA run's span ``syncs`` into ``feddd_device_syncs_total{span}``."""
    from repro_torch.obs.recorder import update_round_metrics
    from repro_torch.obs.runlog import record_from_event
    reg = MetricsRegistry()
    for e in events:
        if e.get("event") == "round":
            update_round_metrics(reg, record_from_event(e),
                                 scheme=e.get("scheme", ""),
                                 path=e.get("path", ""))
        elif e.get("event") == "fault":
            reg.inc("feddd_fault_incidents_total", 1,
                    kind=e.get("kind", "unknown"))
        elif e.get("event") == "span" and "syncs" in e:
            reg.inc("feddd_device_syncs_total", e["syncs"], span=e["name"])
    return reg


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Inspect a FedDD JSONL run log: phase timings, "
                    "byte/failure economies, straggler timelines.")
    ap.add_argument("jsonl", help="run log written via --log-jsonl / "
                                  "ObsConfig.jsonl_path")
    ap.add_argument("--csv", metavar="PATH",
                    help="also write the per-round stream as CSV")
    ap.add_argument("--prom", metavar="PATH",
                    help="also write Prometheus text metrics replayed "
                         "from the log")
    ap.add_argument("--top", type=int, default=5,
                    help="straggler clients to list (default 5)")
    args = ap.parse_args(argv)

    events = read_events(args.jsonl)
    print(render(events, top=args.top), end="")
    if args.csv:
        with open(args.csv, "w", encoding="utf-8") as fh:
            fh.write(rounds_csv(events))
        print(f"\nwrote per-round CSV -> {args.csv}")
    if args.prom:
        with open(args.prom, "w", encoding="utf-8") as fh:
            fh.write(registry_from_events(events).prometheus_text())
        print(f"wrote Prometheus text -> {args.prom}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
