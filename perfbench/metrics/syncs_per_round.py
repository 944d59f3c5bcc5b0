"""Synchronising CUDA calls a round that torch's sync debug mode reports
in the program (``syncs`` of its span events, ``outside_spans``
included), over the traced run's unprofiled window rounds: each is a
point where the host waits for the device to drain."""

from perfbench import window_spans


def read(run):
    spans = window_spans.spans(run)
    if not spans or any("syncs" not in e for e in spans):
        return None
    return sum(e["syncs"] for e in spans) / len({e["round"] for e in spans})
