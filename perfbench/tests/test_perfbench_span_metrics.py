"""The readers of the program's traced span fields (``syncs``,
``host_ns``, ``device_ns``) on a synthetic run: each reads the window
rounds the profiler did not record, leaving out the round after them,
and returns None on span events without the fields."""

import pytest

from perfbench import harness

MS = 1_000_000
PROFILED = [3, 4]       # the round after them, 5, pays for the profiler


def _spans(rounds=range(1, 9), fields=True):
    """Per round t: ``local_train`` enqueued in (10 + t) ms on the host
    from t s on, its stream busy 20 ms from 1 ms after the host start,
    ``t`` syncs in ``engine_step`` and, in even rounds, one outside every
    span; a round the profiler slowed (3-5) reads ten times as much."""
    out = []
    for t in rounds:
        k = 10 if t in (3, 4, 5) else 1
        h0 = t * 1_000_000_000
        host = [h0, h0 + k * (10 + t) * MS]
        dev = [h0 + MS, h0 + MS + k * 20 * MS]
        lt = {"event": "span", "name": "local_train", "t_start": float(t),
              "dur_s": (host[1] - host[0]) * 1e-9, "round": t}
        es = {"event": "span", "name": "engine_step", "t_start": t + 0.5,
              "dur_s": 1e-3, "round": t}
        if fields:
            lt.update(host_ns=host, device_ns=dev, parent=None, syncs=0)
            es.update(host_ns=[host[1], host[1] + MS], device_ns=None,
                      parent=None, syncs=k * t)
        out += [lt, es]
        if fields and t % 2 == 0:
            out.append({"event": "span", "name": "outside_spans",
                        "t_start": t + 0.9, "dur_s": 0.0, "round": t,
                        "host_ns": None, "device_ns": None, "parent": None,
                        "syncs": 1})
    # a span of no round (an eval span) counts nowhere
    out.append({"event": "span", "name": "eval", "t_start": 9.0,
                "dur_s": 1.0, **({"host_ns": [0, 10 ** 9],
                                  "device_ns": [0, 10 ** 9], "parent": None,
                                  "syncs": 50} if fields else {})})
    return out


def _run(spans, traced=PROFILED):
    return harness.RunData(cfg={"specs": [[["fc", 4, 2]]], "global_spec": 0},
                           traffic={"h": 5}, client_spec=[0, 0],
                           setup_s=1.0, round_s=[0.5] * 8, window_s=4.0,
                           flops_per_round=10 ** 9,
                           peaks={"fp32_flops": 67e12,
                                  "hbm_bytes_s": 3.35e12},
                           spans=spans, traced_round_ids=list(traced))


UNPROFILED = [1, 2, 6, 7, 8]
WANT = {
    # engine_step's t syncs, and one outside spans in rounds 2, 6, 8
    "syncs_per_round": (sum(UNPROFILED) + 3) / 5,
    "local_train_enqueue_ms": sum(10 + t for t in UNPROFILED) / 5,
    "local_train_stream_ms": 20.0,
    # device end less host end: 1 + 20 - (10 + t) ms, median at t = 6
    "host_lead_ms": 5.0,
}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_the_unprofiled_rounds(metric):
    got = harness.reader(metric)(_run(_spans()))
    assert got == pytest.approx(WANT[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_every_round_without_a_profiled_stretch(metric):
    """No profiled rounds: nothing is left out."""
    rounds = [1, 2, 6, 7, 8]
    got = harness.reader(metric)(_run(_spans(rounds), traced=[]))
    assert got == pytest.approx(WANT[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_without_the_new_fields_returns_nothing(metric):
    """The span events of a program that writes none of the fields (the
    parent's, or an untimed device) give None, never 0."""
    assert harness.reader(metric)(_run(_spans(fields=False))) is None
    assert harness.reader(metric)(_run([])) is None


@pytest.mark.parametrize("metric", ["local_train_stream_ms",
                                    "host_lead_ms"])
def test_device_readers_skip_spans_the_device_did_not_time(metric):
    spans = _spans()
    for e in spans:
        if e["name"] == "local_train":
            e["device_ns"] = None
    assert harness.reader(metric)(_run(spans)) is None
