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
* optional ``torch.profiler`` annotations (``ObsConfig.trace``): every
  host span also enters ``torch.profiler.record_function(name)``, so
  spans line up with the kernels in a torch.profiler trace.  The engine
  step's own phases (core/round_engine.py) enter :func:`profiler_scope`,
  which annotates only while a profiler is recording.

Spans are host ``perf_counter`` intervals and never synchronise the
device: a span around asynchronous device work measures its launches, and
the span that ends in the round's one device-to-host copy
(``host_transfer``) absorbs the wait.  Everything the recorder consumes
is already on the host: recording adds no device-to-host transfers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.runlog import SCHEMA_VERSION, JsonlWriter, round_event

# Round-pipeline phase names (host spans and the engine step's profiler
# scopes in core/round_engine.py use the same vocabulary).
PHASES = ("allocate", "local_train", "encode", "transport", "decode",
          "aggregate", "eval", "engine_step", "host_transfer",
          "chunk_dispatch", "client_update")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knobs (``ProtocolConfig.obs``).

    enabled: master switch.  Any of the other fields being set also
      activates recording (setting a log path IS opting in).
    jsonl_path: write the structured JSONL run log here (repro_torch.obs.runlog;
      overwritten per run).
    trace: wrap host spans in ``torch.profiler.record_function`` so
      they show up in profiler traces next to device activity.
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
    """Live recorder: metrics + spans + JSONL events for one run."""

    active = True

    def __init__(self, cfg: ObsConfig, *, driver: str, **meta):
        self.cfg = cfg
        self.registry = cfg.registry if cfg.registry is not None \
            else MetricsRegistry()
        self._writer = (JsonlWriter(cfg.jsonl_path)
                        if cfg.jsonl_path else None)
        self._t0 = time.perf_counter()
        self._rounds = 0
        self._host_s = 0.0
        self._sim_s = 0.0
        self._closed = False
        self.event("run_start", schema=SCHEMA_VERSION, driver=driver,
                   **meta)

    # -- spans -----------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str,
             round: Optional[int] = None) -> Iterator[None]:  # noqa: A002
        """Host-side span around one pipeline phase.  With
        ``ObsConfig.trace`` the span also enters
        ``torch.profiler.record_function``, so profiler timelines carry
        the same names."""
        ctx = (torch.profiler.record_function(name) if self.cfg.trace
               else contextlib.nullcontext())
        start = time.perf_counter()
        with ctx:
            yield
        self.span_done(name, start, round=round)

    def span_done(self, name: str, t_start: float,
                  round: Optional[int] = None) -> None:  # noqa: A002
        """Record a span that already ran, from its ``perf_counter`` start.

        For phases awkward to wrap in a ``with`` block (the sim runner's
        event-timeline section).  No profiler annotation — retroactive
        spans cannot wrap device dispatches.
        """
        dur = time.perf_counter() - t_start
        self.registry.observe("feddd_span_seconds", dur, name=name)
        ev = {"name": name, "t_start": t_start - self._t0, "dur_s": dur}
        if round is not None:
            ev["round"] = int(round)
        self.event("span", **ev)

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
        collective actually moved; the ``feddd_cross_device_bytes`` gauge
        tracks the latest round so dashboards see the live (1-D) per-link
        saving next to the cumulative counters."""
        self.registry.inc("feddd_collective_dense_bytes_total",
                          float(dense_bytes))
        self.registry.inc("feddd_collective_bytes_total",
                          float(wire_bytes))
        self.registry.set("feddd_cross_device_bytes", float(wire_bytes))
        self.event("collective", dense=float(dense_bytes),
                   wire=float(wire_bytes))

    def round(self, record, *, path: str = "", scheme: str = "",
              client_times=None) -> None:
        """Fold one finished RoundRecord into metrics + the run log.

        ``client_times`` (optional, (N,) float, NaN = did not upload) are
        the per-client upload-completion offsets on the SIMULATED clock —
        the straggler-timeline axis of ``repro_torch.obs.report``.
        """
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
        """Final run_end event + run-level gauges.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        wall = time.perf_counter() - self._t0
        rps = self._rounds / wall if wall > 0 else 0.0
        self.registry.set("feddd_rounds_per_sec", rps)
        self.event("run_end", rounds=self._rounds, wall_s=wall,
                   host_round_s=self._host_s, sim_s=self._sim_s,
                   rounds_per_sec=rps)
        if self._writer is not None:
            self._writer.close()


def profiler_scope(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else a null context: the engine's phase annotations cost nothing when
    no trace is taken."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def make_recorder(cfg: Optional[ObsConfig], *, driver: str, **meta):
    """Recorder for an active config, :data:`NULL_RECORDER` otherwise."""
    if cfg is None or not cfg.active:
        return NULL_RECORDER
    return Recorder(cfg, driver=driver, **meta)
