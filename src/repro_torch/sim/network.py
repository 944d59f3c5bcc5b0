"""Per-client network/compute condition models for the FL simulator.

`core/protocol.py` freezes telemetry at round 0 (the paper's Table-4
sample), so every round sees the same links.  These models own the
*ground truth* conditions per communication epoch instead; the server in
sim/runner.py never reads them directly — it estimates rates from the
event timeline (observed telemetry) and re-solves the allocation LP from
those estimates.

A model maps an epoch index to :class:`NetworkConditions` — the true
``(uplink_rate, downlink_rate, compute_latency)`` arrays of that epoch.
For the wave policies (sync/deadline) the epoch is the round number; for
the async policy it is each client's own dispatch count.

All models are deterministic functions of their constructor seed: epoch
sequences are memoised so ``conditions(e)`` returns identical values
regardless of call order or process (the determinism contract of
tests/test_torch_sim.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.allocation import ClientTelemetry


class NetworkConditions(NamedTuple):
    """True per-client conditions of one epoch; arrays shaped (N,)."""

    uplink_rate: np.ndarray      # bytes / s
    downlink_rate: np.ndarray    # bytes / s
    compute_latency: np.ndarray  # seconds per local-training pass


def telemetry_with_conditions(tel: ClientTelemetry,
                              cond: NetworkConditions) -> ClientTelemetry:
    """A copy of ``tel`` whose link/compute fields are ``cond``'s."""
    return dataclasses.replace(
        tel, uplink_rate=np.asarray(cond.uplink_rate, float),
        downlink_rate=np.asarray(cond.downlink_rate, float),
        compute_latency=np.asarray(cond.compute_latency, float))


class NetworkModel:
    """Base: ``conditions(epoch)`` -> true conditions of that epoch."""

    num_clients: int

    def conditions(self, epoch: int) -> NetworkConditions:
        raise NotImplementedError


class StaticNetwork(NetworkModel):
    """Table-4 conditions frozen for the whole run — the exact setting of
    ``core/protocol.py``'s closed-form clock, so the synchronous policy
    over this model reproduces Eq. (12) round times (tests/test_torch_sim.py).
    """

    def __init__(self, tel: ClientTelemetry):
        self.num_clients = tel.num_clients
        self._cond = NetworkConditions(
            uplink_rate=np.asarray(tel.uplink_rate, float),
            downlink_rate=np.asarray(tel.downlink_rate, float),
            compute_latency=np.asarray(tel.compute_latency, float))

    def conditions(self, epoch: int) -> NetworkConditions:
        del epoch
        return self._cond


class MarkovFadingNetwork(NetworkModel):
    """Two-state (good/bad) Gilbert–Elliott fading per client.

    Each client carries an independent Markov chain over epochs:

        P(good -> bad)  = p_fade
        P(bad  -> good) = p_recover

    In the bad state the client's uplink and downlink rates are scaled by
    ``fade_factor`` (deep fade) and its compute latency by
    ``compute_slowdown`` (e.g. thermal throttling / contention).  All
    clients start in the good state at epoch 0, i.e. epoch 0 equals the
    base Table-4 sample.

    The chain is advanced lazily and memoised, so the model is a
    deterministic function of (base telemetry, seed) alone.
    """

    def __init__(self, tel: ClientTelemetry, *, p_fade: float = 0.2,
                 p_recover: float = 0.5, fade_factor: float = 0.1,
                 compute_slowdown: float = 1.0, seed: int = 0):
        if not (0.0 <= p_fade <= 1.0 and 0.0 <= p_recover <= 1.0):
            raise ValueError("transition probabilities must be in [0,1]")
        self.num_clients = tel.num_clients
        self.p_fade = p_fade
        self.p_recover = p_recover
        self.fade_factor = fade_factor
        self.compute_slowdown = compute_slowdown
        self._base = StaticNetwork(tel).conditions(0)
        self._rng = np.random.default_rng(seed)
        # _states[e] is the (N,) bool "bad" vector of epoch e.
        self._states: List[np.ndarray] = [np.zeros(tel.num_clients, bool)]

    def _advance_to(self, epoch: int) -> None:
        while len(self._states) <= epoch:
            bad = self._states[-1]
            u = self._rng.uniform(size=self.num_clients)
            nxt = np.where(bad, u >= self.p_recover, u < self.p_fade)
            self._states.append(nxt)

    def conditions(self, epoch: int) -> NetworkConditions:
        self._advance_to(epoch)
        bad = self._states[epoch]
        link = np.where(bad, self.fade_factor, 1.0)
        slow = np.where(bad, self.compute_slowdown, 1.0)
        base = self._base
        return NetworkConditions(
            uplink_rate=base.uplink_rate * link,
            downlink_rate=base.downlink_rate * link,
            compute_latency=base.compute_latency * slow)


class TraceNetwork(NetworkModel):
    """Trace-driven conditions: explicit per-epoch rate arrays.

    ``uplink`` / ``downlink`` / ``compute`` are (T, N) arrays (or lists of
    (N,) rows); epoch e uses row ``e % T``.  Useful for replaying measured
    link traces and for constructing adversarial straggler scenarios in
    tests (e.g. one client's uplink collapsing 10x at a known epoch).
    """

    def __init__(self, uplink: Sequence, downlink: Sequence,
                 compute: Sequence):
        self._up = np.atleast_2d(np.asarray(uplink, float))
        self._down = np.atleast_2d(np.asarray(downlink, float))
        self._cmp = np.atleast_2d(np.asarray(compute, float))
        if not (self._up.shape == self._down.shape == self._cmp.shape):
            raise ValueError("trace arrays must share shape (T, N)")
        self.num_clients = self._up.shape[1]

    def conditions(self, epoch: int) -> NetworkConditions:
        r = epoch % self._up.shape[0]
        return NetworkConditions(self._up[r], self._down[r], self._cmp[r])

    @classmethod
    def straggler_collapse(cls, tel: ClientTelemetry, *, epochs: int = 12,
                           clients: Sequence[int] = (0,),
                           factor: float = 50.0,
                           from_epoch: int = 1) -> "TraceNetwork":
        """Canonical adversarial trace: ``clients``' uplinks collapse by
        ``factor`` from ``from_epoch`` on (everything else held at the
        base telemetry).  The scenario the deadline/partial-aggregation
        and fault-injection tests drive (tests/test_torch_faults.py,
        chip_smoke.py)."""
        up = np.tile(np.asarray(tel.uplink_rate, float), (epochs, 1))
        for c in clients:
            up[from_epoch:, int(c)] /= factor
        return cls(up,
                   np.tile(np.asarray(tel.downlink_rate, float),
                           (epochs, 1)),
                   np.tile(np.asarray(tel.compute_latency, float),
                           (epochs, 1)))


def make_network(name: str, tel: ClientTelemetry, *,
                 seed: int = 0, **kw) -> NetworkModel:
    """Factory keyed by the benchmark-grid names."""
    if name == "static":
        return StaticNetwork(tel)
    if name == "markov":
        return MarkovFadingNetwork(tel, seed=seed, **kw)
    if name == "straggler":
        return TraceNetwork.straggler_collapse(tel, **kw)
    raise ValueError(f"unknown network model {name!r} "
                     "(other trace models are constructed directly)")
