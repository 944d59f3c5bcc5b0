"""How far the host runs ahead of the device: the median, over the
traced run's unprofiled window rounds, of the program's ``local_train``
span's device end less its host end (``device_ns``, ``host_ns``), the
device work still queued when the host has finished launching local
SGD.  Near 0 the host paces the round."""

import statistics

from perfbench import window_spans


def read(run):
    spans = window_spans.local_train(run, "host_ns", "device_ns")
    if not spans:
        return None
    return 1e-6 * statistics.median(e["device_ns"][1] - e["host_ns"][1]
                                    for e in spans)
