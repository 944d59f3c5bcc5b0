"""A ``torch.profiler`` trace of a stretch of rounds, read into what the
per-layer metrics take: the device's operations with their times, the
host range each kernel was launched from, and the traced window.

The profiler's Chrome trace names each event's kind in ``cat``: device
work is ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the host's launch
calls are ``cuda_runtime`` / ``cuda_driver`` and share a ``correlation``
id with the kernel they launched; ``record_function`` ranges (the
program's obs spans and the benchmark's ``perfbench.window``) are
``user_annotation``.  Times are microseconds on one clock.

The session (``profiler``) records the device's work and the launch
calls through CUPTI, and on the host only the ``record_function``
ranges: not every ATen operator, whose recording would cost the host
about as much as a round's own work (some 20,000 launches a round) and
so leave the device idle for the profiler's sake."""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import torch

WINDOW = "perfbench.window"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]                  # us
    kernels: List[Tuple[str, float, float, int]]  # name, start, end, corr
    device_ops: List[Tuple[str, float, float]]   # kernels, copies, sets
    launch_ts: Dict[int, float]                  # correlation -> host us
    ranges: Dict[str, List[Tuple[float, float]]]  # annotation -> spans
    rounds: int                                  # rounds traced

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def _in_window(self, ops):
        a, b = self.window
        return [(n, max(s, a), min(e, b)) for n, s, e, *_ in ops
                if e > a and s < b]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return _union((s, e) for _, s, e in self._in_window(self.device_ops))

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernels_in_window(self):
        a, b = self.window
        return [k for k in self.kernels
                if a <= self.launch_ts.get(k[3], k[1]) <= b]

    def kernels_launched_in(self, range_name: str):
        """Kernels whose launch call lies inside a range of that name."""
        spans = sorted(self.ranges.get(range_name, []))
        out = []
        for k in self.kernels_in_window():
            t = self.launch_ts.get(k[3])
            if t is not None and any(s <= t <= e for s, e in spans):
                out.append(k)
        return out

    def kernel_seconds(self, kernels) -> float:
        """Seconds in which at least one of ``kernels`` ran (kernels of
        several streams can overlap)."""
        return sum(e - s for s, e in _union((s, e) for _, s, e, _ in
                                            kernels)) * 1e-6

    def device_ops_top(self, count: int = 10):
        tot: Dict[str, float] = collections.Counter()
        for n, s, e in self._in_window(self.device_ops):
            tot[n] += (e - s) * 1e-6
        return [[n, v] for n, v in tot.most_common(count)]

    def idle_by_host_range(self, names: Sequence[str], count: int = 10):
        """The device's idle time in the window, summed by the host range
        (of ``names``, the innermost) open at the middle of each gap."""
        a, b = self.window
        gaps, at = [], a
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if b > at:
            gaps.append((at, b))
        spans = [(s, e, n) for n in names for s, e in self.ranges.get(n, [])]
        tot: Dict[str, float] = collections.Counter()
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inside = [(se - ss, n) for ss, se, n in spans if ss <= mid <= se]
            tot[min(inside)[1] if inside else "between spans"] += (e - s) * 1e-6
        return [[n, v] for n, v in tot.most_common(count)]


def profiler(device: torch.device):
    """A ``torch.profiler`` session, not yet started, that records device
    work and only the host's user ranges (``RecordScope.USER_SCOPE``).
    ``torch.profiler.profile`` takes no such filter, so its call of the
    autograd profiler's ``_enable_profiler`` is handed the scope while
    ``start`` runs."""
    from torch.autograd import profiler as autograd_profiler
    from torch._C._profiler import RecordScope

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)
    start = prof.start
    enable = autograd_profiler._enable_profiler

    def scoped_start():
        autograd_profiler._enable_profiler = (
            lambda config, activities, scopes=None:
            enable(config, activities, {RecordScope.USER_SCOPE}))
        try:
            start()
        finally:
            autograd_profiler._enable_profiler = enable

    prof.start = scoped_start
    return prof


def _union(spans) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def load(path: str, rounds: int) -> Optional[Trace]:
    """The trace written by ``export_chrome_trace``; None if it holds no
    ``perfbench.window`` range."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    kernels, device_ops, ranges = [], [], collections.defaultdict(list)
    launch_ts: Dict[int, float] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        ts = float(ev.get("ts", 0.0))
        end = ts + float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in _DEVICE:
            device_ops.append((ev["name"], ts, end))
            if cat == "kernel":
                kernels.append((ev["name"], ts, end,
                                int(args.get("correlation", -1))))
        elif cat in _LAUNCH and "correlation" in args:
            launch_ts[int(args["correlation"])] = ts
        elif cat == "user_annotation":
            ranges[ev["name"]].append((ts, end))
    if not ranges.get(WINDOW):
        return None
    return Trace(ranges[WINDOW][0], kernels, device_ops, launch_ts,
                 dict(ranges), rounds)
