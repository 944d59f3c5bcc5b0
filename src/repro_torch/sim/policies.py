"""Server aggregation policies — who the server waits for, and how it
weighs what arrives.

The paper's protocol is synchronous: the server "needs to wait for the
slowest client" (FedDD §1), which is exactly what differential dropout is
designed to mitigate.  The simulator makes that a pluggable choice so the
time-to-accuracy comparison (``python -m repro_torch.straggler_sim``) can compare
FedDD under three serving disciplines:

* :class:`SyncPolicy` — wait for every upload; the round ends at the last
  arrival (Eq. (12) semantics; reproduces core/protocol.py exactly under a
  static network, tests/test_torch_sim.py).
* :class:`DeadlinePolicy` — FedCS-style semi-synchronous round: the server
  sets a deadline from its *observed* telemetry and a straggler that has
  not finished uploading by then is cut off — its in-flight transfer is
  abandoned, its update is excluded from Eq. (4) (a 0 aggregation weight
  in the stacked engine step), and it rejoins the next wave.
* :class:`RetryPolicy` — sync with a hard timeout, the serving discipline
  for LOSSY uplinks (sim/faults.py): the server waits for every expected
  upload (retransmits and their backoff included) but never longer than
  ``slack`` x the slowest expected round trip — a client that silently
  died cannot stall the round forever, yet a retransmitting one gets the
  headroom a plain deadline would deny it.
* :class:`AsyncPolicy` — buffered fully-asynchronous serving (FedBuff /
  FedAsync style): the server merges as soon as ``buffer_size`` uploads
  are in, weighting each by a staleness decay ``(1 + s)^(-alpha)`` where
  ``s`` counts global versions elapsed since the client downloaded.
  Clients re-dispatch immediately after each merge, so fast clients lap
  stragglers instead of waiting for them.

Wave policies (sync/deadline) expose ``horizon(expected_durations)`` —
how long past dispatch the server listens, computed from the durations it
*expects* given its observed telemetry (``inf`` = wait for all).  The
async policy instead parameterises the event loop in sim/runner.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

POLICIES = ("sync", "deadline", "retry", "async")


@dataclasses.dataclass(frozen=True)
class SyncPolicy:
    """Wait-for-all (the paper's protocol)."""

    name: str = dataclasses.field(default="sync", init=False)

    def horizon(self, expected_durations: np.ndarray) -> float:
        del expected_durations
        return float("inf")


@dataclasses.dataclass(frozen=True)
class DeadlinePolicy:
    """Semi-synchronous: cut off uploads later than an adaptive deadline.

    The listening horizon is ``slack`` x the ``quantile``-th expected
    round-trip duration, where expectations come from the server's
    observed telemetry — the server budgets for the fleet it *believes*
    it has, and a client whose link faded since the last estimate simply
    misses the cut.  The runner always keeps at least one upload (the
    earliest arrival) so a round is never empty (with a fault model
    attached, the quorum rule replaces that fallback).

    ``partial=True`` enables partial aggregation of cut uploads
    (homogeneous fleets): instead of abandoning an in-flight transfer
    outright, the server aggregates the per-leaf prefix of mask channels
    whose bytes landed before the deadline — kept channels serialize in
    ascending channel order (repro_torch.comm.payload), so the delivered byte
    count maps exactly to a per-leaf kept-channel prefix
    (:func:`repro_torch.comm.payload.delivered_prefix_counts`).
    """

    quantile: float = 0.75
    slack: float = 1.5
    partial: bool = False
    name: str = dataclasses.field(default="deadline", init=False)

    def horizon(self, expected_durations: np.ndarray) -> float:
        return self.slack * float(
            np.quantile(np.asarray(expected_durations, float),
                        self.quantile))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded patience: wait for all expected uploads, up to a timeout.

    The horizon is ``slack`` x the SLOWEST expected round-trip duration.
    Expectations come from observed telemetry and do not include
    retransmit delays, so ``slack > 1`` is the headroom granted to lossy
    uplinks (sim/faults.py): a retransmitting client lands inside the
    horizon and its retries are waited out, while a crashed or silently
    dead client can stall the round by at most the timeout.  With no
    faults and ``slack >= 1`` this reduces to :class:`SyncPolicy` over
    any network the expectations track.
    """

    slack: float = 3.0
    name: str = dataclasses.field(default="retry", init=False)

    def horizon(self, expected_durations: np.ndarray) -> float:
        return self.slack * float(
            np.max(np.asarray(expected_durations, float)))


@dataclasses.dataclass(frozen=True)
class AsyncPolicy:
    """Buffered async serving parameters (consumed by sim/runner.py).

    ``buffer_size == 0`` means "pick at runtime": ``max(1, N // 4)``.
    """

    alpha: float = 0.5       # staleness decay exponent
    buffer_size: int = 0     # uploads per merge
    name: str = dataclasses.field(default="async", init=False)

    def resolved_buffer(self, num_clients: int) -> int:
        k = self.buffer_size or max(1, num_clients // 4)
        return min(k, num_clients)

    def staleness_scale(self, staleness: np.ndarray) -> np.ndarray:
        """Weight multiplier ``(1 + s)^(-alpha)`` (FedAsync polynomial)."""
        return (1.0 + np.asarray(staleness, float)) ** (-self.alpha)


def make_policy(name: str, **kw):
    """Factory keyed by the benchmark-grid names."""
    if name == "sync":
        return SyncPolicy(**kw)
    if name == "deadline":
        return DeadlinePolicy(**kw)
    if name == "retry":
        return RetryPolicy(**kw)
    if name == "async":
        return AsyncPolicy(**kw)
    raise ValueError(f"unknown policy {name!r}; expected one of {POLICIES}")
