"""Availability processes: who, out of a 100k+ client population, is
online at each epoch.

A production FL service never sees its whole population at once — most
devices are offline, charging, or on a metered link (Caldas et al.,
1812.07210).  The models here decide the ONLINE SET each epoch; the
cohort sampler (repro_torch.population.sampler) then draws the round's fleet
from that set.

RNG discipline
--------------
Draws follow the same ``(seed, tag, epoch, client)`` keying contract as
``repro_torch/sim/faults.py``: every per-client uniform is a pure function of
that tuple, so draws are call-order independent, prefix/permutation
invariant, and identical across processes.  The fault layer realises the
contract with one ``np.random.default_rng((seed, tag, epoch, i))`` per
client — fine for fleets of tens, but a Python-level generator per
client is O(population) interpreter work per epoch.  Availability must
answer "who is online" over the FULL population every epoch, so here the
same keyed-tuple semantics are realised with a vectorized counter-based
hash (splitmix64's finalizer) over ``np.uint64`` lanes: one fused numpy
expression yields all N uniforms at once.  Distinct ``tag`` bytes keep
these streams out of the fault layer's (0xFA) and corruption (0xC0)
domains.

Models
------
* :class:`AlwaysOn` — everyone online every epoch (the identity-contract
  default: population == fleet degenerates to today's runs);
* :class:`BernoulliAvailability` — i.i.d. online with probability ``p``
  per (epoch, client);
* :class:`DiurnalAvailability` — deterministic sine on/off with a
  per-client phase (drawn once at epoch 0), modelling timezone-staggered
  charging windows; ``duty`` sets the online fraction of each period;
* :class:`TraceAvailability` — replay a ``(T, N)`` boolean trace,
  row ``epoch % T``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# Domain tags for the (seed, tag, epoch, client) keying — disjoint from
# the fault layer's _TAG_FAULTS (0xFA) / _TAG_CORRUPT (0xC0).
_TAG_AVAIL = 0xA1      # per-(epoch, client) availability uniforms
_TAG_PHASE = 0xA2      # per-client diurnal phase (epoch pinned to 0)
_TAG_SAMPLE = 0xA3     # per-(epoch, client) cohort-sampling uniforms

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)     # splitmix64 increment
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over uint64 lanes (vectorized)."""
    x = (x ^ (x >> np.uint64(30))) * _MIX1
    x = (x ^ (x >> np.uint64(27))) * _MIX2
    return x ^ (x >> np.uint64(31))


def uniform_draws(seed: int, tag: int, epoch: int,
                  clients: np.ndarray) -> np.ndarray:
    """Uniform(0, 1) per client, a pure function of
    ``(seed, tag, epoch, client)``.

    ``clients`` is an integer array of GLOBAL client ids; the result has
    the same shape.  Restricting or permuting ``clients`` never changes
    any individual client's draw (the per-client key is independent of
    the others) — the property the determinism tests pin.
    """
    c = np.asarray(clients, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
        h = _mix64(np.asarray(h ^ (np.uint64(tag) * _GOLDEN)))
        h = _mix64(h ^ (np.uint64(epoch & 0xFFFFFFFFFFFFFFFF) * _GOLDEN))
        u = _mix64(_mix64(h ^ (c * _GOLDEN)))
    # 53-bit mantissa route: exact doubles in [0, 1)
    return (u >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


class AvailabilityModel:
    """Base: ``online(epoch)`` returns a boolean mask over the population
    (or, with ``clients=``, the draws restricted to those ids)."""

    size: int

    def online(self, epoch: int,
               clients: Optional[np.ndarray] = None) -> np.ndarray:
        raise NotImplementedError

    def _ids(self, clients: Optional[np.ndarray]) -> np.ndarray:
        if clients is None:
            return np.arange(self.size, dtype=np.int64)
        return np.asarray(clients, dtype=np.int64)


class AlwaysOn(AvailabilityModel):
    """Everyone online every epoch — population degenerates to fleet."""

    def __init__(self, size: int):
        self.size = int(size)

    def online(self, epoch: int,
               clients: Optional[np.ndarray] = None) -> np.ndarray:
        return np.ones(len(self._ids(clients)), dtype=bool)


class BernoulliAvailability(AvailabilityModel):
    """i.i.d. online with probability ``p`` per (epoch, client)."""

    def __init__(self, size: int, p: float = 0.7, seed: int = 0):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"availability p must be in [0, 1], got {p}")
        self.size = int(size)
        self.p = float(p)
        self.seed = int(seed)

    def online(self, epoch: int,
               clients: Optional[np.ndarray] = None) -> np.ndarray:
        ids = self._ids(clients)
        return uniform_draws(self.seed, _TAG_AVAIL, epoch, ids) < self.p


class DiurnalAvailability(AvailabilityModel):
    """Sine on/off with a per-client phase: client ``i`` is online iff

        sin(2*pi*(epoch / period + phase_i)) >= sin(pi*(0.5 - duty))

    so a ``duty`` fraction of each ``period`` is spent online, and the
    phases (one keyed draw per client, epoch pinned to 0) stagger the
    fleet across "timezones".  Fully deterministic given (seed, epoch).
    """

    def __init__(self, size: int, period: float = 24.0, duty: float = 0.5,
                 seed: int = 0):
        if period <= 0.0:
            raise ValueError(f"period must be positive, got {period}")
        if not 0.0 < duty <= 1.0:
            raise ValueError(f"duty must be in (0, 1], got {duty}")
        self.size = int(size)
        self.period = float(period)
        self.duty = float(duty)
        self.seed = int(seed)
        self._threshold = float(np.sin(np.pi * (0.5 - self.duty)))

    def _phase(self, ids: np.ndarray) -> np.ndarray:
        return uniform_draws(self.seed, _TAG_PHASE, 0, ids)

    def online(self, epoch: int,
               clients: Optional[np.ndarray] = None) -> np.ndarray:
        ids = self._ids(clients)
        wave = np.sin(2.0 * np.pi * (epoch / self.period
                                     + self._phase(ids)))
        return wave >= self._threshold


class TraceAvailability(AvailabilityModel):
    """Replay a ``(T, N)`` boolean availability trace, row ``epoch % T``."""

    def __init__(self, trace: Sequence[Sequence[bool]]):
        tr = np.asarray(trace, dtype=bool)
        if tr.ndim != 2 or tr.shape[0] < 1:
            raise ValueError("trace must be a (T, N) boolean array")
        self.trace = tr
        self.size = int(tr.shape[1])

    def online(self, epoch: int,
               clients: Optional[np.ndarray] = None) -> np.ndarray:
        row = self.trace[int(epoch) % self.trace.shape[0]]
        return row[self._ids(clients)]


def make_availability(name, size: int, *, seed: int = 0,
                      **kw) -> AvailabilityModel:
    """Factory: ``always`` | ``bernoulli`` | ``diurnal`` | ``trace``
    (or pass an :class:`AvailabilityModel` through unchanged)."""
    if isinstance(name, AvailabilityModel):
        if name.size != size:
            raise ValueError(
                f"availability model covers {name.size} clients, "
                f"population has {size}")
        return name
    if name == "always":
        return AlwaysOn(size)
    if name == "bernoulli":
        return BernoulliAvailability(size, seed=seed, **kw)
    if name == "diurnal":
        return DiurnalAvailability(size, seed=seed, **kw)
    if name == "trace":
        return TraceAvailability(**kw)
    raise ValueError(f"unknown availability model {name!r} "
                     "(expected always|bernoulli|diurnal|trace)")
