"""Host milliseconds a round in the allocation LP (``core/allocation.py``,
numpy), from the program's ``allocate`` obs span, the mean over the
traced run's window rounds (the span is synchronous host work)."""


def read(run):
    if not run.spans:
        return None
    durs = [e["dur_s"] for e in run.spans if e["name"] == "allocate"]
    return 1e3 * sum(durs) / len(durs) if durs else None
