"""The :class:`Population`: sticky per-client state for populations far
larger than any round's fleet.

A population is the service's durable view of every registered client —
most of whom are offline at any moment and many of whom have never been
served.  State lives in flat host numpy arrays indexed by GLOBAL client
id, O(1) per client, so a 100k-client population costs a few MB and a
handful of O(population) passes at construction only.  On the round hot
path the work is confined to the sampled cohort: the availability mask
and sampler are the single O(population) vectorized step, and every
read-modify-write after that touches ``cohort_size`` rows.

Sticky state per client:

* economy — cumulative uploaded bytes, failure count, rounds
  participated, last participation round;
* learning — last observed train loss (runner prior: 1.0), last
  FedDD dropout rate (Algorithm 1 prior: 0.0), sticky Oort utility
  (prior: ``num_samples * sqrt(max(train_loss, 0))``), and, for clients
  whose local model has diverged from the global, their parameter
  pytree (bounded by the number of DISTINCT participants, not the
  population);
* ``seen`` — whether the client has ever been materialized into a
  cohort; first-contact clients can fall back to population-mean
  telemetry in the Eq. (9)-(11) LP (``cold_start="mean"``) instead of
  their individual prior (``cold_start="prior"``, the default — and the
  bit-identity-preserving choice).

The telemetry EWMAs themselves live in the runner's
:class:`repro_torch.sim.runner.ObservedTelemetry`, which in population mode is
sized to the population and indexed by global id, so estimates survive
cohort churn without aliasing between clients.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.allocation import ClientTelemetry
from repro_torch.population.availability import (AvailabilityModel,
                                           make_availability)
from repro_torch.population.sampler import CohortSampler, make_sampler

# prior-telemetry fields a cold-start "mean" LP solve replaces for
# never-seen cohort members (model_bytes is structural, never averaged)
_MEAN_FIELDS = ("uplink_rate", "downlink_rate", "compute_latency",
                "num_samples", "label_coverage")


def _own_copy(params):
    """A pytree whose tensors own their storage: a cohort's rows arrive as
    views of the engine's (cohort, ...) stacks, and a kept view would pin
    the whole stack (and alias a later in-place write)."""
    return tree.tree_map(
        lambda l: l.clone() if isinstance(l, torch.Tensor) else l, params)


class Population:
    """Sticky per-client state + availability + cohort sampling.

    ``telemetry`` is the population-sized prior :class:`ClientTelemetry`
    (what the service knows about each client before ever serving it).
    ``availability`` and ``sampler`` accept the factory names of
    :func:`repro_torch.population.availability.make_availability` /
    :func:`repro_torch.population.sampler.make_sampler` or model instances.
    """

    def __init__(self, telemetry: ClientTelemetry, *,
                 availability="always", sampler="uniform",
                 cold_start: str = "prior", seed: int = 0):
        if cold_start not in ("prior", "mean"):
            raise ValueError(
                f"cold_start must be 'prior' or 'mean', got {cold_start!r}")
        self.telemetry = telemetry
        self.size = int(len(np.asarray(telemetry.num_samples)))
        if self.size < 1:
            raise ValueError("population telemetry is empty")
        self.availability: AvailabilityModel = make_availability(
            availability, self.size, seed=seed)
        self.sampler: CohortSampler = make_sampler(sampler, seed=seed)
        self.cold_start = cold_start
        self.seed = int(seed)

        n = self.size
        self.seen = np.zeros(n, dtype=bool)
        self.last_round = np.full(n, -1, dtype=np.int64)
        self.rounds_participated = np.zeros(n, dtype=np.int64)
        self.uploaded_bytes = np.zeros(n, dtype=np.float64)
        self.failures = np.zeros(n, dtype=np.int64)
        self.loss = np.ones(n, dtype=np.float64)          # runner prior
        self.dropout = np.zeros(n, dtype=np.float64)      # Algorithm 1 D=0
        self.utility = (np.asarray(telemetry.num_samples, float)
                        * np.sqrt(np.maximum(
                            np.asarray(telemetry.train_loss, float), 0.0)))
        self._params: Dict[int, object] = {}
        self._means: Optional[Dict[str, float]] = None

    # -- cohort selection (THE per-round O(population) step) ---------------

    def sample_cohort(self, epoch: int, k: int) -> np.ndarray:
        """Sorted global ids of this epoch's cohort (exactly ``k``)."""
        if not 1 <= k <= self.size:
            raise ValueError(
                f"cohort size {k} outside [1, {self.size}]")
        online = self.availability.online(epoch)
        online_ids = np.flatnonzero(online).astype(np.int64)
        ids = np.asarray(
            self.sampler.sample(epoch, k, online_ids, self),
            dtype=np.int64)
        if len(ids) != k:
            raise ValueError(
                f"sampler returned {len(ids)} ids, expected {k}")
        return ids

    def first_contact(self, ids: np.ndarray) -> int:
        """How many of ``ids`` have never been in a cohort before."""
        return int(np.count_nonzero(~self.seen[np.asarray(ids)]))

    # -- cohort materialization -------------------------------------------

    def cohort_params(self, ids: np.ndarray, global_params):
        """Per-client parameter pytrees for the cohort: each client's
        sticky params if it has diverged from the global, else the
        current global model (first contact downloads the global)."""
        return [self._params.get(int(g), global_params) for g in ids]

    def cohort_dropout(self, ids: np.ndarray) -> np.ndarray:
        return self.dropout[np.asarray(ids)].copy()

    def losses_for(self, ids: np.ndarray) -> np.ndarray:
        return self.loss[np.asarray(ids)].copy()

    def seed_params(self, params_list) -> None:
        """Install explicit per-client initial params (len == size)."""
        if len(params_list) != self.size:
            raise ValueError(
                f"expected {self.size} client param trees, "
                f"got {len(params_list)}")
        for g, p in enumerate(params_list):
            self._params[g] = _own_copy(p)

    # -- post-round write-back (O(cohort)) ---------------------------------

    def record_round(self, epoch: int, ids: np.ndarray, *,
                     arrived: np.ndarray, failed: np.ndarray,
                     losses: np.ndarray, uplink_bytes: np.ndarray,
                     utilities: Optional[np.ndarray] = None) -> None:
        """Fold one round's observations back into the sticky arrays.

        All cohort-shaped: ``arrived`` (contributed to Eq. (4)),
        ``failed`` (crashed/aborted), ``losses`` (the runner's running
        loss view), ``uplink_bytes`` (bytes actually charged to the
        wire, 0 for non-contributors), ``utilities`` (fresh Oort
        utilities; only arrived rows are folded in).
        """
        ids = np.asarray(ids)
        arrived = np.asarray(arrived, bool)
        self.seen[ids] = True
        hit = ids[arrived]
        self.last_round[hit] = int(epoch)
        self.rounds_participated[hit] += 1
        self.uploaded_bytes[ids] += np.asarray(uplink_bytes, float)
        self.failures[ids[np.asarray(failed, bool)]] += 1
        self.loss[ids] = np.asarray(losses, float)
        if utilities is not None:
            u = np.asarray(utilities, float)
            ok = arrived & np.isfinite(u)
            self.utility[ids[ok]] = u[ok]

    def fold_back(self, ids: np.ndarray, params_list, *,
                  dropout: np.ndarray, losses: np.ndarray) -> None:
        """Park the outgoing cohort's learning state before rebinding
        the engines to a new cohort."""
        ids = np.asarray(ids)
        self.dropout[ids] = np.asarray(dropout, float)
        self.loss[ids] = np.asarray(losses, float)
        for g, p in zip(ids, params_list):
            self._params[int(g)] = _own_copy(p)

    # -- allocation integration --------------------------------------------

    def _prior_means(self) -> Dict[str, float]:
        if self._means is None:
            self._means = {
                f: float(np.mean(np.asarray(getattr(self.telemetry, f),
                                            float)))
                for f in _MEAN_FIELDS}
        return self._means

    def lp_telemetry(self, tel: ClientTelemetry,
                     ids: np.ndarray) -> ClientTelemetry:
        """Cold-start view of the cohort telemetry for the Eq. (9)-(11)
        solve: under ``cold_start="mean"``, never-seen cohort members
        take population-mean prior telemetry (and the mean of the seen
        members' losses) instead of their individual rows.  Under the
        default ``"prior"`` the telemetry passes through untouched —
        the identity-contract configuration."""
        if self.cold_start == "prior":
            return tel
        unseen = ~self.seen[np.asarray(ids)]
        if not unseen.any():
            return tel
        m = self._prior_means()
        repl = {}
        for f in _MEAN_FIELDS:
            arr = np.asarray(getattr(tel, f), float).copy()
            arr[unseen] = m[f]
            repl[f] = arr
        tl = np.asarray(tel.train_loss, float).copy()
        if (~unseen).any():
            tl[unseen] = float(np.mean(tl[~unseen]))
        repl["train_loss"] = tl
        return dataclasses.replace(tel, **repl)
