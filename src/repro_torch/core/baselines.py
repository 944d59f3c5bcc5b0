"""The Eq. (12) round clock and the client-selection baselines (§6.2).

* FedAvg — everyone uploads the full model (no budget).
* FedCS  — drop the clients with the longest round time until the
           uploaded parameter mass fits the budget (Nishio & Yonetani).
* Oort   — utility-guided selection (Lai et al., OSDI'21): a loss-based
           statistical utility times a straggler penalty, highest utility
           first within the budget.

Every selector returns a boolean participation vector; selected clients
upload FULL models.  The selectors are the JAX package's numpy code: the
same ``np.argsort`` calls on the same float64 arrays, so the same clients
are chosen, ties included.  :func:`select_oort_traced` is the device
twin the scanned multi-round engine calls between rounds: Oort's ranking
depends on the round's losses, which stay on the device there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.allocation import ClientTelemetry


def round_times(tel: ClientTelemetry, dropout: Optional[np.ndarray] = None,
                *, uplink_bytes: Optional[np.ndarray] = None) -> np.ndarray:
    """t_n = t_cmp + U(1-D)/r_u + U(1-D)/r_d (Eq. (12) summand).

    ``uplink_bytes`` replaces the uplink leg's idealized ``U(1-D)`` with
    the codec's on-wire bytes (:mod:`repro_torch.comm`); the downlink
    broadcast stays idealized."""
    d = np.zeros(tel.num_clients) if dropout is None else dropout
    u_eff = tel.model_bytes * (1.0 - d)
    up = u_eff if uplink_bytes is None else np.asarray(uplink_bytes)
    return (tel.compute_latency
            + up / tel.uplink_rate
            + u_eff / tel.downlink_rate)


def select_fedavg(tel: ClientTelemetry) -> np.ndarray:
    """FedAvg: every client uploads its full model."""
    return np.ones(tel.num_clients, bool)


def _greedy_within_budget(order: np.ndarray, tel: ClientTelemetry,
                          a_server: float) -> np.ndarray:
    """Admit clients in ``order`` while their models fit A_server * sum(U);
    always keep at least the first."""
    budget = a_server * float(np.sum(tel.model_bytes))
    sel = np.zeros(tel.num_clients, bool)
    used = 0.0
    for i in order:
        if used + tel.model_bytes[i] <= budget + 1e-9:
            sel[i] = True
            used += tel.model_bytes[i]
    if not sel.any():
        sel[order[0]] = True
    return sel


def select_fedcs(tel: ClientTelemetry, *, a_server: float) -> np.ndarray:
    """Keep the fastest clients until the budget A_server * sum(U) is spent."""
    return _greedy_within_budget(np.argsort(round_times(tel)), tel, a_server)


@dataclasses.dataclass
class OortState:
    """Exploitation statistics for Oort (simplified faithful variant)."""
    straggler_penalty: float = 2.0   # alpha (= 2 per FedDD §6.2)

    def utilities(self, tel: ClientTelemetry,
                  round_deadline: Optional[float] = None) -> np.ndarray:
        """m_n * sqrt(loss_n) * the straggler penalty (Oort's Eq. (1) at
        client level)."""
        stat = tel.num_samples * np.sqrt(np.maximum(tel.train_loss, 0.0))
        return stat * oort_system_penalty(tel, state=self,
                                          round_deadline=round_deadline)


def oort_system_penalty(tel: ClientTelemetry, *,
                        state: Optional[OortState] = None,
                        round_deadline: Optional[float] = None
                        ) -> np.ndarray:
    """The loss-independent factor of Oort's utility, static per
    telemetry: ``(deadline / t_n) ** alpha`` for clients slower than the
    deadline (default: the 80th percentile of the Eq. (12) times), else 1."""
    state = state or OortState()
    t = round_times(tel)
    if round_deadline is None:
        round_deadline = float(np.percentile(t, 80))
    return np.where(
        t > round_deadline,
        (round_deadline / np.maximum(t, 1e-9)) ** state.straggler_penalty,
        1.0)


def select_oort_traced(train_loss: torch.Tensor, *,
                       num_samples: torch.Tensor,
                       system_penalty: torch.Tensor,
                       model_bytes: torch.Tensor,
                       budget) -> torch.Tensor:
    """:func:`select_oort` on device tensors, with no host sync: the
    (N,) bool participation of the highest-utility clients whose models
    fit ``budget`` bytes, at least the top-ranked one.

    float32 on the losses' device (the numpy selector is float64), ranked
    by a stable argsort of ``-utility``; the greedy admits the clients in
    that order with a float32 running total, one client per step.  The
    static ``system_penalty`` is :func:`oort_system_penalty`, computed
    once on the host.  As in the JAX package, the two selectors can
    differ only where utilities tie to float32 resolution or a budget
    boundary falls between them: the stable argsort keeps the lower
    index first, numpy's default sort need not."""
    util = num_samples * torch.sqrt(torch.clamp(train_loss, min=0.0)) \
        * system_penalty
    order = torch.argsort(-util, stable=True)
    ranked_bytes = model_bytes[order]
    used = torch.zeros((), dtype=torch.float32, device=util.device)
    takes = []
    for i in range(util.shape[0]):
        take = used + ranked_bytes[i] <= budget + 1e-9
        used = used + torch.where(take, ranked_bytes[i], 0.0)
        takes.append(take)
    taken = torch.stack(takes)
    taken[0] |= ~torch.any(taken)      # always keep the top-ranked client
    return torch.zeros_like(taken).scatter_(0, order, taken)


def select_oort(tel: ClientTelemetry, *, a_server: float,
                state: Optional[OortState] = None) -> np.ndarray:
    """Highest-utility clients within the parameter budget."""
    state = state or OortState()
    return _greedy_within_budget(np.argsort(-state.utilities(tel)), tel,
                                 a_server)
