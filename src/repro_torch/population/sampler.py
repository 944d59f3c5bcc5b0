"""Cohort samplers: draw the round's fleet from the online population.

Each sampler maps ``(epoch, k, online ids, store)`` to EXACTLY ``k``
sorted global client ids.  The fixed cohort size keeps the engines'
(cohort, ...) stacks and every kernel launch at one shape however
availability churns.  When fewer than ``k`` clients are online, the shortfall is
topped up deterministically from the offline set (most recently
participating first, then lowest id) — the sim treats them as reachable
but slow to respond rather than shrinking the round.

Randomized samplers use the same vectorized ``(seed, tag, epoch,
client)`` keyed uniforms as the availability layer
(:func:`repro_torch.population.availability.uniform_draws`), so cohorts are
call-order independent and cross-process identical.

* :class:`IdentitySampler` — the whole population, in id order, every
  round (``static``: engines never rebind); with always-on availability
  this is the bit-identity contract's configuration;
* :class:`UniformSampler` — uniform without replacement over the online
  set (k smallest keyed uniforms);
* :class:`AvailabilityWeightedSampler` — Efraimidis–Spirakis weighted
  reservoir over the online set, weight ``1 / (1 + rounds_participated)``
  — rarely-served clients are favored when they do come online;
* :class:`OortSampler` — top-``(1 - explore) * k`` by the store's sticky
  Oort utility among seen online clients, the rest exploration slots
  for never-seen clients (Lai et al., Oort).
"""

from __future__ import annotations

import numpy as np

from repro_torch.population.availability import _TAG_SAMPLE, uniform_draws


def _top_up(chosen: np.ndarray, k: int, online_ids: np.ndarray,
            store) -> np.ndarray:
    """Fill ``chosen`` up to exactly ``k`` ids, deterministically.

    Preference order for the fill: remaining ONLINE clients first (by
    id), then offline clients by most recent participation
    (``last_round`` descending, id ascending).  Pure function of the
    store's sticky state — no RNG.
    """
    chosen = np.asarray(chosen, dtype=np.int64)
    if len(chosen) >= k:
        return np.sort(chosen[:k])
    need = k - len(chosen)
    taken = np.zeros(store.size, dtype=bool)
    taken[chosen] = True
    spare_online = online_ids[~taken[online_ids]]
    fill = spare_online[:need]
    chosen = np.concatenate([chosen, fill])
    taken[fill] = True
    need = k - len(chosen)
    if need > 0:
        rest = np.flatnonzero(~taken)
        order = np.lexsort((rest, -store.last_round[rest]))
        chosen = np.concatenate([chosen, rest[order[:need]]])
    return np.sort(chosen)


class CohortSampler:
    """Base: ``sample(epoch, k, online_ids, store)`` -> k sorted ids."""

    #: True when the cohort is the same every round (engines keep their
    #: buffers bound for the whole run) — required by the mesh path.
    static = False

    def sample(self, epoch: int, k: int, online_ids: np.ndarray,
               store) -> np.ndarray:
        raise NotImplementedError


class IdentitySampler(CohortSampler):
    """The full population, in id order, every round."""

    static = True

    def sample(self, epoch: int, k: int, online_ids: np.ndarray,
               store) -> np.ndarray:
        if k != store.size:
            raise ValueError(
                f"identity sampler needs cohort_size == population size "
                f"({store.size}), got {k}")
        return np.arange(store.size, dtype=np.int64)


class UniformSampler(CohortSampler):
    """Uniform without replacement over the online set."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def sample(self, epoch: int, k: int, online_ids: np.ndarray,
               store) -> np.ndarray:
        if len(online_ids) == 0:
            return _top_up(np.empty(0, np.int64), k, online_ids, store)
        u = uniform_draws(self.seed, _TAG_SAMPLE, epoch, online_ids)
        take = min(k, len(online_ids))
        pick = online_ids[np.argsort(u, kind="stable")[:take]]
        return _top_up(pick, k, online_ids, store)


class AvailabilityWeightedSampler(CohortSampler):
    """Efraimidis–Spirakis weighted sampling without replacement over
    the online set; weight ``1 / (1 + rounds_participated)`` steers
    rounds toward clients the service has rarely reached."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def sample(self, epoch: int, k: int, online_ids: np.ndarray,
               store) -> np.ndarray:
        if len(online_ids) == 0:
            return _top_up(np.empty(0, np.int64), k, online_ids, store)
        u = uniform_draws(self.seed, _TAG_SAMPLE, epoch, online_ids)
        w = 1.0 / (1.0 + store.rounds_participated[online_ids])
        # E-S key: u^(1/w); log-space for numerical sanity
        key = np.log(np.maximum(u, 1e-300)) / w
        take = min(k, len(online_ids))
        pick = online_ids[np.argsort(-key, kind="stable")[:take]]
        return _top_up(pick, k, online_ids, store)


class OortSampler(CohortSampler):
    """Utility top-k with an exploration budget: the exploit slots take
    the highest sticky Oort utility among SEEN online clients, the
    explore slots take never-seen online clients (keyed-uniform order)."""

    def __init__(self, explore: float = 0.1, seed: int = 0):
        if not 0.0 <= explore <= 1.0:
            raise ValueError(f"explore must be in [0, 1], got {explore}")
        self.explore = float(explore)
        self.seed = int(seed)

    def sample(self, epoch: int, k: int, online_ids: np.ndarray,
               store) -> np.ndarray:
        if len(online_ids) == 0:
            return _top_up(np.empty(0, np.int64), k, online_ids, store)
        seen = store.seen[online_ids]
        k_explore = int(round(self.explore * k))
        u = uniform_draws(self.seed, _TAG_SAMPLE, epoch, online_ids)
        unseen_ids = online_ids[~seen]
        explore_pick = unseen_ids[np.argsort(u[~seen], kind="stable")
                                  [:min(k_explore, len(unseen_ids))]]
        k_exploit = k - len(explore_pick)
        seen_ids = online_ids[seen]
        util = store.utility[seen_ids]
        # tie-break by id: lexsort minor key first
        order = np.lexsort((seen_ids, -util))
        exploit_pick = seen_ids[order[:min(k_exploit, len(seen_ids))]]
        pick = np.concatenate([exploit_pick, explore_pick])
        return _top_up(pick, k, online_ids, store)


def make_sampler(name, *, seed: int = 0, **kw) -> CohortSampler:
    """Factory: ``identity`` | ``uniform`` | ``weighted`` | ``oort``
    (or pass a :class:`CohortSampler` through unchanged)."""
    if isinstance(name, CohortSampler):
        return name
    if name == "identity":
        return IdentitySampler()
    if name == "uniform":
        return UniformSampler(seed=seed, **kw)
    if name == "weighted":
        return AvailabilityWeightedSampler(seed=seed, **kw)
    if name == "oort":
        return OortSampler(seed=seed, **kw)
    raise ValueError(f"unknown cohort sampler {name!r} "
                     "(expected identity|uniform|weighted|oort)")
