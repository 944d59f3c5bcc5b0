"""Host milliseconds a round in the program's ``local_train`` span
(``host_ns``): how long the host takes to enqueue local SGD, the mean
over the traced run's unprofiled window rounds."""

from perfbench import window_spans


def read(run):
    spans = window_spans.local_train(run, "host_ns")
    if not spans:
        return None
    return 1e-6 * sum(e["host_ns"][1] - e["host_ns"][0]
                      for e in spans) / len(spans)
