"""Unified observability layer: metrics registry, round/span tracing,
structured JSONL run logs, and a run-inspection CLI.

Entry points:

* :class:`ObsConfig` — rides ``ProtocolConfig.obs``; default is inert.
* :func:`make_recorder` — a :class:`Recorder` for active configs, the
  shared :data:`NULL_RECORDER` (all no-ops) otherwise.
* :class:`MetricsRegistry` — counters/gauges/histograms with labels,
  Prometheus-text + CSV rendering.
* ``repro_torch.obs.runlog`` — schema-versioned JSONL events; round events
  round-trip to bit-identical RoundRecords.
* ``python -m repro_torch.obs.report <run.jsonl>`` — phase/byte/failure
  summaries, straggler timelines, ``--csv`` / ``--prom`` export.

Import discipline: core modules import ``repro_torch.obs``; nothing in
this package imports core at module level (runlog pulls RoundRecord
lazily), so the dependency edge stays one-way.  The package is the
port's own copy of the JAX package's ``obs`` (pure Python), with
``torch.profiler`` in place of ``jax.profiler``.
"""

from repro_torch.obs.metrics import DEFAULT_BUCKETS, MetricsRegistry
from repro_torch.obs.recorder import (NULL_RECORDER, ObsConfig, NullRecorder,
                                PHASES, Recorder, make_recorder,
                                profiler_scope, update_round_metrics)
from repro_torch.obs.runlog import (SCHEMA_VERSION, JsonlWriter,
                              history_from_events, jsonable, load_history,
                              read_events, record_from_event, round_event)

__all__ = [
    "DEFAULT_BUCKETS", "MetricsRegistry",
    "NULL_RECORDER", "ObsConfig", "NullRecorder", "PHASES", "Recorder",
    "make_recorder", "profiler_scope", "update_round_metrics",
    "SCHEMA_VERSION", "JsonlWriter", "history_from_events", "jsonable",
    "load_history", "read_events", "record_from_event", "round_event",
]
