"""Discrete-event clock and queue — the time axis of the FL simulator.

The protocol driver (core/protocol.py) models time as one closed-form
``max`` per round (paper Eq. (12)); that is exact for the synchronous
policy but cannot express deadlines, stragglers finishing mid-round, or
asynchronous merges.  This engine owns an explicit event timeline instead:

* :class:`Event` — an immutable (time, seq, kind, client, payload) record.
  Ordering is ``(time, seq)``: the monotone ``seq`` counter breaks time
  ties in SCHEDULING order, so a run's event order is a pure function of
  the schedule calls — same seed, same code path ⇒ the same event order
  in every process (tests/test_torch_sim.py pins this).
* :class:`EventQueue` — a binary-heap priority queue of events.
* :class:`Simulator` — queue + clock.  ``schedule`` inserts relative to
  ``now``; ``step`` pops the earliest event, advances the clock to its
  time, and appends it to ``trace``.

Event kinds used by the FL runner (sim/runner.py) are the module
constants below; the engine itself is agnostic and carries any string.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, List, Optional, Tuple

# Event kinds of a client round trip (scheduled in this causal order):
DOWNLOAD_DONE = "download_done"   # client received the (masked) global model
COMPUTE_DONE = "compute_done"     # local training finished
UPLOAD_DONE = "upload_done"       # sparse update arrived at the server


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    """One timeline entry.  Sort key is ``(time, seq)`` only."""

    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    client: int = dataclasses.field(compare=False, default=-1)
    payload: Any = dataclasses.field(compare=False, default=None)


class EventQueue:
    """Min-heap of :class:`Event` with a deterministic tie-break counter."""

    def __init__(self) -> None:
        self._heap: List[Event] = []
        self._seq = 0

    def push(self, time: float, kind: str, client: int = -1,
             payload: Any = None) -> Event:
        ev = Event(time=float(time), seq=self._seq, kind=kind,
                   client=client, payload=payload)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def clear(self) -> List[Event]:
        """Cancel every pending event (deadline cut-off: in-flight
        transfers of the closing round are abandoned).  Returns the
        cancelled events in time order."""
        out = sorted(self._heap)
        self._heap = []
        return out

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class Simulator:
    """Event queue + simulated clock.

    ``now`` is simulated seconds (the paper's Eq. (12) time domain), NOT
    host seconds — see :class:`repro_torch.core.protocol.RoundRecord` for the
    sim_time / host_wall_time distinction.
    """

    def __init__(self) -> None:
        self.queue = EventQueue()
        self.now: float = 0.0
        # (time, kind, client) triples of every processed event, in order —
        # the determinism witness asserted by tests/test_torch_sim.py.
        self.trace: List[Tuple[float, str, int]] = []

    def schedule(self, delay: float, kind: str, client: int = -1,
                 payload: Any = None) -> Event:
        """Schedule ``kind`` at ``now + delay`` (delay >= 0)."""
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        return self.queue.push(self.now + delay, kind, client, payload)

    def schedule_at(self, time: float, kind: str, client: int = -1,
                    payload: Any = None) -> Event:
        """Schedule ``kind`` at an absolute simulated time (>= now)."""
        if time < self.now - 1e-12:
            raise ValueError(f"cannot schedule into the past "
                             f"({time} < now={self.now})")
        return self.queue.push(time, kind, client, payload)

    def step(self) -> Event:
        """Pop the earliest event, advance the clock, record the trace."""
        ev = self.queue.pop()
        self.now = ev.time
        self.trace.append((ev.time, ev.kind, ev.client))
        return ev

    def advance_to(self, time: float) -> None:
        """Move the clock forward without an event (e.g. the server sits
        idle until its round deadline)."""
        if time < self.now - 1e-12:
            raise ValueError(f"clock cannot run backwards "
                             f"({time} < now={self.now})")
        self.now = max(self.now, float(time))

    def drain(self, kind: Optional[str] = None) -> List[Event]:
        """Step until the queue is empty; return the processed events
        (optionally only those matching ``kind``)."""
        out: List[Event] = []
        while self.queue:
            ev = self.step()
            if kind is None or ev.kind == kind:
                out.append(ev)
        return out
