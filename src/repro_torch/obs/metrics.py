"""Label-aware metrics registry — counters, gauges, histograms.

The registry is the shared numeric export path of the port: live runs
feed it through :class:`repro_torch.obs.recorder.Recorder` (round totals,
byte economies, fault incidents, span timings) and offline tools rebuild
one from a JSONL run log (``repro_torch.obs.report --prom``), so both
render through the SAME Prometheus/CSV serializers.

Deliberately tiny and dependency-free (stdlib + numpy-compatible floats):
no background threads, no clocks, no global state — a registry is a plain
dict the caller owns.  All mutation is O(1) per sample; rendering sorts
for deterministic output.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

# Default histogram buckets: host-seconds scale (spans, round walls).
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   60.0, float("inf"))

_KINDS = ("counter", "gauge", "histogram")


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = key + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(f) if not f.is_integer() else str(int(f))


class _Histogram:
    __slots__ = ("buckets", "counts", "total", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.total += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:  # per-bucket counts; render accumulates for le=
                self.counts[i] += 1
                break


class MetricsRegistry:
    """Counters / gauges / histograms with labels.

    Metrics auto-register on first touch with the touching method's kind;
    re-using a name with a different kind raises (one name, one kind —
    the Prometheus contract).
    """

    def __init__(self):
        self._kinds: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}
        self._data: Dict[str, Dict[Tuple, object]] = {}

    # -- registration / mutation -----------------------------------------

    def _declare(self, name: str, kind: str, help_: str = "") -> None:
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        prev = self._kinds.get(name)
        if prev is not None and prev != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{prev}, cannot re-register as {kind}")
        self._kinds[name] = kind
        if help_:
            self._help[name] = help_
        self._data.setdefault(name, {})

    def describe(self, name: str, kind: str, help_: str = "",
                 buckets: Optional[Iterable[float]] = None) -> None:
        """Optional up-front declaration (kind + help text + buckets)."""
        self._declare(name, kind, help_)
        if buckets is not None:
            self._buckets[name] = tuple(sorted(set(
                list(buckets) + [float("inf")])))

    def inc(self, name: str, value: float = 1.0, /, **labels) -> None:
        """Counter increment (monotone; negative increments raise)."""
        if value < 0:
            raise ValueError(f"counter {name!r} increment must be >= 0")
        self._declare(name, "counter")
        key = _label_key(labels)
        cur = self._data[name].get(key, 0.0)
        self._data[name][key] = float(cur) + float(value)

    def set(self, name: str, value: float, /, **labels) -> None:
        """Gauge set (last write wins)."""
        self._declare(name, "gauge")
        self._data[name][_label_key(labels)] = float(value)

    def observe(self, name: str, value: float, /, **labels) -> None:
        """Histogram observation."""
        self._declare(name, "histogram")
        key = _label_key(labels)
        h = self._data[name].get(key)
        if h is None:
            h = _Histogram(self._buckets.get(name, DEFAULT_BUCKETS))
            self._data[name][key] = h
        h.observe(value)

    # -- reads -----------------------------------------------------------

    def value(self, name: str, /, **labels) -> Optional[float]:
        """Current counter/gauge value (None when never touched)."""
        series = self._data.get(name, {})
        v = series.get(_label_key(labels))
        return None if v is None or isinstance(v, _Histogram) else float(v)

    def samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        """Flat (name, labels, value) view; histograms flatten to their
        ``_sum`` / ``_count`` series.  Sorted, deterministic."""
        out = []
        for name in sorted(self._data):
            for key in sorted(self._data[name]):
                v = self._data[name][key]
                labels = dict(key)
                if isinstance(v, _Histogram):
                    out.append((f"{name}_sum", labels, v.total))
                    out.append((f"{name}_count", labels, float(v.count)))
                else:
                    out.append((name, labels, float(v)))
        return out

    # -- rendering (the one export path) ---------------------------------

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        for name in sorted(self._data):
            kind = self._kinds[name]
            if name in self._help:
                lines.append(f"# HELP {name} {self._help[name]}")
            lines.append(f"# TYPE {name} {kind}")
            for key in sorted(self._data[name]):
                v = self._data[name][key]
                if isinstance(v, _Histogram):
                    acc = 0
                    for b, c in zip(v.buckets, v.counts):
                        acc += c
                        le = _fmt_labels(key, (("le", _fmt_value(b)),))
                        lines.append(f"{name}_bucket{le} {acc}")
                    lbl = _fmt_labels(key)
                    lines.append(f"{name}_sum{lbl} {v.total!r}")
                    lines.append(f"{name}_count{lbl} {v.count}")
                else:
                    lines.append(f"{name}{_fmt_labels(key)} {float(v)!r}")
        return "\n".join(lines) + "\n"

    def csv_rows(self, header: bool = True) -> List[str]:
        """``metric,labels,value`` rows (histograms as _sum/_count)."""
        rows = ["metric,labels,value"] if header else []
        for name, labels, v in self.samples():
            lbl = ";".join(f"{k}={val}" for k, val in sorted(labels.items()))
            rows.append(f"{name},{lbl},{v!r}")
        return rows
