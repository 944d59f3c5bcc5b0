"""Schema-versioned JSONL run log — one event per line.

Event kinds (the ``event`` field):

* ``run_start`` — first line of every log; carries ``schema`` (this
  module's :data:`SCHEMA_VERSION`), the driver (``protocol`` | ``sim``),
  and run metadata (scheme, fleet size, executor/policy, rounds); traced,
  ``clock``: a ``perf_counter_ns`` reading and the trace clock's at the
  same moment, the zero of ``t_start``.
* ``round`` — one per :class:`~repro_torch.core.protocol.RoundRecord`, a
  faithful serialization of every record field (plus ``path`` and the
  optional per-client upload-completion offsets ``client_up`` the
  straggler timeline renders).  The round stream ROUND-TRIPS: feeding a
  log back through :func:`history_from_events` reconstructs the exact
  ``RunResult`` history, bit for bit — Python's ``json`` emits float64
  ``repr`` which parses back to the identical double, and every array
  field is written as a list of native floats.
* ``span`` — one per host-side span (``name``, run-relative ``t_start``
  and ``dur_s``, optional ``round``); with ``ObsConfig.trace`` also
  ``host_ns`` and ``device_ns`` ([start, end] on the profiler trace's
  clock, ``device_ns`` null where the device was not timed) and, on a
  CUDA device, ``syncs`` (repro_torch.obs.recorder).  A traced
  CUDA run charges the syncs outside every span to a span named
  ``outside_spans`` of no duration, one per round that had any.
* ``fault`` — one per fault incident (crash / retry / abort / corrupt /
  quarantine / quorum_skip), written by an event-driven simulator.
* ``run_end`` — totals (rounds, host seconds, rounds/sec); a traced CUDA
  run adds ``sync_sites``, the synchronising calls by ``file:line``.

Everything here is host-side plumbing over data the drivers already
pulled (the round's one device-to-host copy): writing a log adds
NO device->host syncs (tests/test_torch_obs.py counts them).  A traced
run's log is held in memory and written in one go when the run closes;
any other run's is written event by event.
"""

from __future__ import annotations

import json
from typing import Dict, IO, List, Optional

import numpy as np

SCHEMA_VERSION = 1

# RoundRecord fields serialized into / parsed out of a ``round`` event.
_RECORD_SCALARS = ("round", "sim_time", "host_wall_time", "mean_loss",
                   "uploaded_fraction", "participants", "sim_round_time",
                   "uploaded_bytes", "wire_bytes", "epsilon", "survivors",
                   "retries", "abandoned_bytes", "quarantined_bytes",
                   "skipped")


def jsonable(x):
    """Numpy-aware conversion to plain JSON types (exact for float64:
    ``json`` round-trips doubles via repr)."""
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.bool_,)):
        return bool(x)
    if isinstance(x, np.ndarray):
        return [jsonable(v) for v in x.tolist()]
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    return x


class JsonlWriter:
    """JSONL sink; one ``write`` = one line = one event.  By default each
    event reaches the file as it is written, so a run that is killed
    keeps the lines before it.  ``buffered`` (a traced run) keeps the
    events in memory and writes them, in order, at ``close``: no file I/O
    while the run records, and its span events may still be filled in.
    The file is opened, and truncated, at its first line."""

    def __init__(self, path: str, buffered: bool = False):
        self.path = str(path)
        self._buffered = buffered
        self._fh: Optional[IO] = None
        self._events: Optional[List[Dict]] = []     # None once closed

    def write(self, event: Dict) -> Dict:
        """Write a plain-JSON copy of ``event``, or keep it when
        buffered; returns the copy."""
        kept = jsonable(event)
        if self._events is None:
            return kept
        if self._buffered:
            self._events.append(kept)
        else:
            self._lines([kept])
            self._fh.flush()
        return kept

    def _lines(self, events: List[Dict]) -> None:
        if self._fh is None:
            self._fh = open(self.path, "w", encoding="utf-8")
        self._fh.writelines(json.dumps(e, separators=(",", ":")) + "\n"
                            for e in events)

    def close(self) -> None:
        if self._events is None:
            return
        events, self._events = self._events, None
        try:
            if events:
                self._lines(events)
        finally:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def round_event(record, **extra) -> Dict:
    """Serialize one RoundRecord (+ extra context fields) to an event."""
    ev = {"event": "round"}
    for f in _RECORD_SCALARS:
        ev[f] = jsonable(getattr(record, f))
    ev["dropout_rates"] = jsonable(np.asarray(record.dropout_rates))
    ev["metrics"] = jsonable(record.metrics)
    ev.update({k: jsonable(v) for k, v in extra.items()})
    return ev


def record_from_event(ev: Dict):
    """Inverse of :func:`round_event` — an identical RoundRecord."""
    from repro_torch.core.protocol import RoundRecord  # lazy: core imports obs
    kw = {f: ev[f] for f in _RECORD_SCALARS if f in ev}
    metrics = ev.get("metrics")
    return RoundRecord(dropout_rates=np.asarray(ev["dropout_rates"],
                                                np.float64),
                       metrics=metrics, **kw)


def read_events(path: str) -> List[Dict]:
    """Parse a JSONL run log; validates the run_start schema header."""
    events = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    if not events:
        raise ValueError(f"empty run log: {path}")
    head = events[0]
    if head.get("event") != "run_start":
        raise ValueError(f"run log {path} does not start with a "
                         f"run_start event (got {head.get('event')!r})")
    schema = head.get("schema")
    if schema != SCHEMA_VERSION:
        raise ValueError(f"run log {path} has schema {schema!r}; this "
                         f"reader understands {SCHEMA_VERSION}")
    return events


def history_from_events(events: List[Dict]) -> List:
    """The round stream of a parsed log as RoundRecords (exact)."""
    return [record_from_event(ev) for ev in events
            if ev.get("event") == "round"]


def load_history(path: str) -> List:
    """read_events + history_from_events in one call."""
    return history_from_events(read_events(path))
