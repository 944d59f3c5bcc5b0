"""Device milliseconds a round from the stream reaching the program's
``local_train`` span to its reaching the span's end (``device_ns``):
local SGD's busy time plus what the device waited for the host inside
the phase; the mean over the traced run's unprofiled window rounds.
Its gap to ``local_train_ms`` (the profiler's busy union) is the wait."""

from perfbench import window_spans


def read(run):
    spans = window_spans.local_train(run, "device_ns")
    if not spans:
        return None
    return 1e-6 * sum(e["device_ns"][1] - e["device_ns"][0]
                      for e in spans) / len(spans)
