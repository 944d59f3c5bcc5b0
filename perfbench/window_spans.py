"""The program's span events that the span metrics read: those of the
traced run's window rounds that the profiler did not record, leaving out
the round after them, which pays for stopping it (the rule of
``round_s_p90.host``).  Spans without a round are left out too.

With ``ObsConfig(trace=True)`` on a CUDA device the program's span
events carry ``host_ns`` and ``device_ns`` ([start, end] on the
profiler trace's clock) and ``syncs`` (the synchronising CUDA calls
charged to the span; those outside every span are charged to a span
named ``outside_spans``).  A program that writes no such fields gives
the readers nothing to read: they return None."""

from __future__ import annotations

from typing import Dict, List


def spans(run) -> List[Dict]:
    """Span events of the unprofiled window rounds, in log order."""
    if not run.spans:
        return []
    skip = set(run.traced_round_ids)
    if skip:
        skip.add(max(skip) + 1)
    return [e for e in run.spans
            if e.get("round") is not None and e["round"] not in skip]


def local_train(run, *fields: str) -> List[Dict]:
    """The ``local_train`` spans of those rounds that carry ``fields``."""
    return [e for e in spans(run) if e["name"] == "local_train"
            and all(e.get(f) is not None for f in fields)]
