"""Run recorder — the one observability hook the drivers talk to.

:class:`ObsConfig` rides :class:`repro_torch.core.protocol.ProtocolConfig`
(field ``obs``); the protocol driver builds a recorder per run via
:func:`make_recorder`.  The default config is INERT: it resolves to the
shared :data:`NULL_RECORDER`, whose every method is a no-op returning
immediately — disabled observability leaves learning state bit-identical
on every execution path.

A live :class:`Recorder` composes three sinks:

* a :class:`~repro_torch.obs.metrics.MetricsRegistry` (own or shared via
  ``ObsConfig.registry``) — round/byte/failure counters, per-scheme
  loss/accuracy gauges, span histograms;
* an optional JSONL run log (``ObsConfig.jsonl_path`` —
  repro_torch.obs.runlog), one event per round / span / fault incident;
  a traced run's is held in memory and written at :meth:`Recorder.close`;
* optional ``torch.profiler`` annotations (``ObsConfig.trace``): every
  host span also enters ``torch.profiler.record_function(name)``, so
  spans line up with the kernels in a torch.profiler trace.  The engine
  step's own phases (core/round_engine.py) enter :func:`profiler_scope`,
  which annotates only while a profiler is recording.

Spans are host ``perf_counter`` intervals (``t_start``, ``dur_s``) and
never synchronise the device: a span around asynchronous device work
measures its launches.  With ``ObsConfig.trace`` each span event also
carries

* ``host_ns``: [start, end] on the clock of torch.profiler's Chrome trace
  (:data:`trace_clock_ns`), so a span sits beside the device's work in a
  trace;
* ``device_ns``: on a CUDA device, [start, end] on that same clock at
  which the device's stream reached the span's entry and its exit (a
  timing event recorded at each), else null;
* ``syncs``: on a CUDA device, the synchronising CUDA calls charged to the
  span (torch's sync debug mode reports each; a call is charged to the
  innermost open span, and one outside every span to
  :data:`OUTSIDE_SPANS`, a span event of no duration written with its
  round).

The device times cost no sync of their own.  The round's device-to-host
copy goes through :meth:`Recorder.to_host`, which records an event just
before it and, once the copy has returned with that event complete (the
copy drained the stream), one more, an anchor, with the host's reading
just before its record.  On the idle stream the device takes the anchor
as soon as the host submits it, and never before that reading, so each
anchor bounds the device timer's place on the host clock from below; the
latest of those bounds over the last :data:`ANCHORS` copies, carried to
one anchor by the events' elapsed times, is its completion (the host
reading a copy's return instead reads late by the copy's wake-up, 0.05-
0.4 ms on an H100, and one reading before a record reads early by
whatever delays the record).  Every completed event's device time is
that anchor's less the events' elapsed time.  Events resolve when
the round reaches :meth:`Recorder.round` (``Event.query`` is the guard;
an event still pending waits for a later round) and, at the latest, at
:meth:`Recorder.close`, the only place that waits on one.  A path whose
copies do not pass through :meth:`Recorder.to_host` keeps ``device_ns``
null.  With ``trace`` off none of this runs: no event, no hook, no
change to the sync debug mode.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import sys
import time
import warnings
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.runlog import SCHEMA_VERSION, JsonlWriter, round_event

# Round-pipeline phase names (host spans and the engine step's profiler
# scopes in core/round_engine.py use the same vocabulary).
PHASES = ("allocate", "local_train", "encode", "transport", "aggregate",
          "eval", "engine_step", "host_transfer", "chunk_dispatch",
          "client_update")

# The host clock of torch.profiler's Chrome trace: an event's ``ts`` (us)
# plus the trace's ``baseTimeNanoseconds`` is CLOCK_REALTIME, which
# ``time.time_ns`` reads (c10's ``getTime``; Kineto converts its CUPTI
# times to the same clock).
trace_clock_ns = time.time_ns

# The warning torch's sync debug mode gives for each synchronising CUDA
# call (c10/cuda ``warn_or_error_on_sync``).
SYNC_WARNING = "called a synchronizing CUDA operation"
# Device times rest on the anchors of this many recent copies: enough to
# find one the device took at once, few enough (seconds of rounds) that
# the device's timer and the host clock cannot drift apart in between.
ANCHORS = 8
# The span name a sync outside every open span is charged to.
OUTSIDE_SPANS = "outside_spans"
# A sync is charged to the innermost frame of this package that made it.
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PACKAGE = os.path.join(_SRC, "repro_torch") + os.sep


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knobs (``ProtocolConfig.obs``).

    enabled: master switch.  Any of the other fields being set also
      activates recording (setting a log path IS opting in).
    jsonl_path: write the structured JSONL run log here (repro_torch.obs.runlog;
      overwritten per run).
    trace: wrap host spans in ``torch.profiler.record_function`` so
      they show up in profiler traces next to device activity, and give
      each span event its trace-clock, device and sync fields (module
      docstring).
    registry: share a :class:`MetricsRegistry` across runs (benchmark
      sweeps aggregating into one export); None gives the run its own.
    """

    enabled: bool = False
    jsonl_path: Optional[str] = None
    trace: bool = False
    registry: Optional[MetricsRegistry] = None

    @property
    def active(self) -> bool:
        return bool(self.enabled or self.jsonl_path or self.trace
                    or self.registry is not None)


class NullRecorder:
    """Inert recorder — every hook no-ops.  Shared singleton
    :data:`NULL_RECORDER`; the disabled-observability bit-identity
    contract rests on these methods doing nothing at all."""

    active = False
    registry = None

    def span(self, name: str, round: Optional[int] = None):  # noqa: A002
        return contextlib.nullcontext()

    def span_done(self, name: str, t_start: float,
                  round: Optional[int] = None) -> None:  # noqa: A002
        pass

    def event(self, kind: str, /, **fields) -> None:
        pass

    def fault(self, round: int, incident: Dict) -> None:  # noqa: A002
        pass

    def uplink(self, uploaded_bytes: float, wire_bytes: float) -> None:
        pass

    def collective(self, dense_bytes: float, wire_bytes: float) -> None:
        pass

    def to_host(self, copy: Callable, *args):
        return copy(*args)

    def round(self, record, *, path: str = "", scheme: str = "",
              client_times=None) -> None:
        pass

    def close(self) -> None:
        pass


NULL_RECORDER = NullRecorder()


def update_round_metrics(reg: MetricsRegistry, record, *, scheme: str,
                         path: str) -> None:
    """Fold one RoundRecord into a registry — THE round->metrics mapping,
    shared by the live recorder and the offline report's ``--prom``
    replay so both render identical numbers."""
    lbl = dict(scheme=scheme, path=path)
    reg.inc("feddd_rounds_total", 1, **lbl)
    if record.skipped:
        reg.inc("feddd_rounds_skipped_total", 1, **lbl)
    if record.retries:
        reg.inc("feddd_retries_total", record.retries, **lbl)
    if record.abandoned_bytes:
        reg.inc("feddd_abandoned_bytes_total", record.abandoned_bytes,
                **lbl)
    if record.quarantined_bytes:
        reg.inc("feddd_quarantined_bytes_total",
                record.quarantined_bytes, **lbl)
    reg.set("feddd_mean_loss", record.mean_loss, scheme=scheme)
    reg.set("feddd_sim_time_seconds", record.sim_time, scheme=scheme)
    if record.metrics and "accuracy" in record.metrics:
        reg.set("feddd_accuracy", float(record.metrics["accuracy"]),
                scheme=scheme)
    reg.observe("feddd_round_host_seconds", record.host_wall_time, **lbl)
    reg.observe("feddd_sim_round_seconds", record.sim_round_time, **lbl)


class Recorder:
    """Live recorder: metrics + spans + JSONL events for one run.

    ``device``: the run's device; with ``ObsConfig.trace`` and a CUDA
    device the spans are timed on the device too and the synchronising
    CUDA calls are counted (module docstring)."""

    active = True

    def __init__(self, cfg: ObsConfig, *, driver: str,
                 device: Optional[torch.device] = None, **meta):
        self.cfg = cfg
        self.registry = cfg.registry if cfg.registry is not None \
            else MetricsRegistry()
        self._writer = (JsonlWriter(cfg.jsonl_path, buffered=cfg.trace)
                        if cfg.jsonl_path else None)
        self._t0 = time.perf_counter()
        self._rounds = 0
        self._host_s = 0.0
        self._sim_s = 0.0
        self._closed = False
        # trace only: the syncs of each open span, innermost last
        self._open: List[list] = []
        self._device = None if device is None else torch.device(device)
        self._cuda = bool(cfg.trace and self._device is not None
                          and self._device.type == "cuda")
        # (span event, entry event, exit event) awaiting their device times
        self._pending: List[tuple] = []
        # (event, trace ns read just before its record) after recent copies
        self._anchors: collections.deque = collections.deque(
            maxlen=ANCHORS)
        self._free: List = []        # completed events, to record again
        self._sites: collections.Counter = collections.Counter()
        self._site_names: Dict[tuple, str] = {}
        self._outside = 0            # syncs outside every span this round
        self._restore = None         # what close() puts back
        if cfg.trace:
            # t_start of a span converts to the trace clock by this pair
            perf_ns = time.perf_counter_ns()
            meta["clock"] = {"perf_counter_ns": perf_ns,
                             "trace_ns": trace_clock_ns()}
            self._t0 = perf_ns * 1e-9
        self.event("run_start", schema=SCHEMA_VERSION, driver=driver,
                   **meta)
        if self._cuda:
            self._watch_syncs()

    # -- spans -----------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str,
             round: Optional[int] = None) -> Iterator[None]:  # noqa: A002
        """Host-side span around one pipeline phase.  With
        ``ObsConfig.trace`` the span also enters
        ``torch.profiler.record_function``, so profiler timelines carry
        the same names, and its event gets the traced fields."""
        if not self.cfg.trace:
            start = time.perf_counter()
            yield
            self.span_done(name, start, round=round)
            return
        this = [0]
        self._open.append(this)
        start_ns = trace_clock_ns()
        start = time.perf_counter()
        entry = self._mark()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self._open.pop()
        leave = self._mark()
        end = time.perf_counter()
        ev = self._span_event(name, start, end - start, round,
                              host_ns=[start_ns, trace_clock_ns()],
                              device_ns=None, syncs=this[0])
        if entry is not None:
            self._pending.append((ev, entry, leave))

    def span_done(self, name: str, t_start: float,
                  round: Optional[int] = None) -> None:  # noqa: A002
        """Record a span that already ran, from its ``perf_counter`` start.

        For phases awkward to wrap in a ``with`` block (the sim runner's
        event-timeline section).  No profiler annotation and no device
        times — retroactive spans cannot wrap device dispatches.
        """
        if not self.cfg.trace:
            self._span_event(name, t_start, time.perf_counter() - t_start,
                             round)
            return
        end_ns = trace_clock_ns()
        dur = time.perf_counter() - t_start
        self._span_event(
            name, t_start, dur, round,
            host_ns=[end_ns - round_ns(dur), end_ns], device_ns=None,
            syncs=0)

    def _span_event(self, name: str, t_start: float, dur: float,
                    round: Optional[int], **traced) -> Dict:  # noqa: A002
        self.registry.observe("feddd_span_seconds", dur, name=name)
        ev = {"event": "span", "name": name, "t_start": t_start - self._t0,
              "dur_s": dur}
        if round is not None:
            ev["round"] = int(round)
        if traced and not self._cuda:
            traced.pop("syncs")
        ev.update(traced)
        return ev if self._writer is None else self._writer.write(ev)

    # -- device times (trace, CUDA) ----------------------------------------

    def _mark(self):
        """A timing event recorded on the run device's current stream;
        None without CUDA."""
        if not self._cuda:
            return None
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    def to_host(self, copy: Callable, *args):
        """``copy(*args)``: a device-to-host copy the round already makes.
        Traced on a CUDA device, it also records an anchor of the device
        times (module docstring); it adds no copy and no sync."""
        if not self._cuda:
            return copy(*args)
        before = self._mark()
        out = copy(*args)
        if before.query():
            # the copy drained the stream: the device takes an event
            # recorded now as soon as the host submits it, and never
            # before the host's reading
            at = trace_clock_ns()
            if len(self._anchors) == self._anchors.maxlen:
                self._free.append(self._anchors[0][0])
            self._anchors.append((self._mark(), at))
            self._free.append(before)
        return out

    def _resolve(self, wait: bool) -> None:
        """Device times of the pending spans whose events completed (all
        of them with ``wait``), against the latest complete anchor.  Its
        completion on the host clock is the latest of the lower bounds
        the recent anchors give it: each completed no earlier than the
        host's reading before its record, and the device's timer spaces
        them; the anchor whose record the device took soonest sets it."""
        if wait:
            for ev, _ in self._anchors:
                ev.synchronize()
        anchors = [(ev, t) for ev, t in self._anchors if ev.query()]
        if not anchors:
            return
        ref = anchors[-1][0]
        at = max(t - round_ns(ref.elapsed_time(ev) * 1e-3)
                 for ev, t in anchors)
        left = []
        for ev, entry, leave in self._pending:
            if wait:
                entry.synchronize()
                leave.synchronize()
            elif not (entry.query() and leave.query()):
                left.append((ev, entry, leave))
                continue
            ev["device_ns"] = [
                at - round_ns(entry.elapsed_time(ref) * 1e-3),
                at - round_ns(leave.elapsed_time(ref) * 1e-3)]
            self._free += (entry, leave)
        self._pending = left

    # -- sync counting (trace, CUDA) ---------------------------------------

    def _watch_syncs(self) -> None:
        """Count the synchronising CUDA calls torch reports: its sync
        debug mode warns on each, and a warnings hook counts every such
        warning and shows none (other warnings go where they went)."""
        caught = warnings.catch_warnings()
        caught.__enter__()
        self._restore = (caught, torch.cuda.get_sync_debug_mode())
        warnings.filterwarnings("always", message=SYNC_WARNING)
        shown = warnings.showwarning

        def hook(message, category, filename, lineno, file=None,
                 line=None):
            if str(message).startswith(SYNC_WARNING):
                self._sync_seen(sys._getframe(1), filename, lineno)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")

    def _sync_seen(self, frame, filename: str, lineno: int) -> None:
        """Charge one synchronising call, reported from ``filename:lineno``
        with ``frame`` on the stack, to the innermost open span and to the
        innermost frame of this package (``repro_torch/...py:line``;
        the reported line where no frame is the package's)."""
        f = frame
        while f is not None and not f.f_code.co_filename.startswith(
                _PACKAGE):
            f = f.f_back
        key = (filename, lineno) if f is None else (f.f_code, f.f_lineno)
        site = self._site_names.get(key)
        if site is None:
            site = self._site_names[key] = (
                f"{os.path.relpath(f.f_code.co_filename, _SRC)}:"
                f"{f.f_lineno}" if f is not None
                else f"{os.path.basename(filename)}:{lineno}")
        self._sites[site] += 1
        if self._open:
            self._open[-1][0] += 1
        else:
            self._outside += 1

    def _unwatch_syncs(self) -> None:
        if self._restore is None:
            return
        caught, mode = self._restore
        self._restore = None
        try:
            torch.cuda.set_sync_debug_mode(mode)
        finally:
            caught.__exit__(None, None, None)

    # -- events ----------------------------------------------------------

    def event(self, kind: str, /, **fields) -> None:
        # ``kind`` is positional-only: fault incidents legitimately carry
        # a "kind" field of their own (crash/retry/...), which must land
        # in ``fields`` rather than collide with the event kind.
        if self._writer is not None:
            self._writer.write({"event": kind, **fields})

    def fault(self, round: int, incident: Dict) -> None:  # noqa: A002
        """One fault incident (a simulator incident dict)."""
        self.registry.inc("feddd_fault_incidents_total", 1,
                          kind=incident.get("kind", "unknown"))
        self.event("fault", round=round, **incident)

    def uplink(self, uploaded_bytes: float, wire_bytes: float) -> None:
        """Byte counters fed from THE shared reduction
        (repro_torch.comm.payload.account_uplink)."""
        self.registry.inc("feddd_uploaded_bytes_total",
                          float(uploaded_bytes))
        self.registry.inc("feddd_wire_bytes_total", float(wire_bytes))

    def collective(self, dense_bytes: float, wire_bytes: float) -> None:
        """Cross-device Eq. (4) reduction bytes, fed from THE shared
        reduction (repro_torch.comm.payload.account_collective).  ``dense_bytes``
        is the dense-psum equivalent, ``wire_bytes`` what the configured
        collective actually moved."""
        self.registry.inc("feddd_collective_dense_bytes_total",
                          float(dense_bytes))
        self.registry.inc("feddd_collective_bytes_total",
                          float(wire_bytes))
        self.event("collective", dense=float(dense_bytes),
                   wire=float(wire_bytes))

    def round(self, record, *, path: str = "", scheme: str = "",
              client_times=None) -> None:
        """Fold one finished RoundRecord into metrics + the run log.

        ``client_times`` (optional, (N,) float, NaN = did not upload) are
        the per-client upload-completion offsets on the SIMULATED clock —
        the straggler-timeline axis of ``repro_torch.obs.report``.
        Traced, the round's spans get their device times first, and the
        syncs outside every span since the last round their event.  Until
        a copy has set an anchor, spans keep ``device_ns`` null and their
        events are dropped: a path that copies nothing holds none.
        """
        if self._pending:
            if self._anchors:
                self._resolve(wait=False)
            else:
                self._pending = []
        if self._outside:
            ev = {"event": "span", "name": OUTSIDE_SPANS,
                  "t_start": time.perf_counter() - self._t0, "dur_s": 0.0,
                  "round": int(record.round), "host_ns": None,
                  "device_ns": None, "syncs": self._outside}
            self._outside = 0
            if self._writer is not None:
                self._writer.write(ev)
        self._rounds += 1
        self._host_s += float(record.host_wall_time)
        self._sim_s = float(record.sim_time)
        update_round_metrics(self.registry, record, scheme=scheme,
                             path=path)
        if self._writer is not None:
            extra = {"path": path, "scheme": scheme}
            if client_times is not None:
                ct = np.asarray(client_times, float)
                extra["client_up"] = [None if not np.isfinite(v)
                                      else float(v) for v in ct]
            self._writer.write(round_event(record, **extra))

    def close(self) -> None:
        """Final run_end event; puts back the sync debug mode and the
        warning filters, settles the last device times and writes the
        log.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            self._unwatch_syncs()
            if self._pending and self._anchors:
                self._resolve(wait=True)
            wall = time.perf_counter() - self._t0
            rps = self._rounds / wall if wall > 0 else 0.0
            sites = ({"sync_sites": dict(self._sites.most_common())}
                     if self._cuda else {})
            self.event("run_end", rounds=self._rounds, wall_s=wall,
                       host_round_s=self._host_s, sim_s=self._sim_s,
                       rounds_per_sec=rps, **sites)
        finally:
            if self._writer is not None:
                self._writer.close()


def round_ns(seconds: float) -> int:
    """Seconds as whole nanoseconds."""
    return int(round(seconds * 1e9))


def profiler_scope(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else a null context: the engine's phase annotations cost nothing when
    no trace is taken."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def make_recorder(cfg: Optional[ObsConfig], *, driver: str,
                  device: Optional[torch.device] = None, **meta):
    """Recorder for an active config, :data:`NULL_RECORDER` otherwise."""
    if cfg is None or not cfg.active:
        return NULL_RECORDER
    return Recorder(cfg, driver=driver, device=device, **meta)
