"""Convergence diagnostics — FedDD §5 (Theorem 2).

* :func:`estimate_epsilon`: the empirical mask-induced aggregation error
  of Assumption 3, on the device of the uploads;
* :func:`theorem2_bound` / :func:`residual_error`: the Eq. (22) bound, and
  :func:`eta_max`, the learning-rate condition
  eta < 2 / (L + L*eps + 4(eps+1)eps) (plain Python floats).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch import tree


def estimate_epsilon(client_params: Sequence,
                     client_masks: Sequence) -> torch.Tensor:
    """Assumption-3 ratio over the concatenation of every leaf:

        || masked_avg - plain_avg ||^2  /  || plain_avg ||^2

    with uniform client weights, in fp32 (a 0-d tensor).  Masks are
    channel-shaped (broadcast against the parameters)."""
    pl = [tree.leaves(p) for p in client_params]
    ml = [tree.leaves(m) for m in client_masks]
    num = den = None
    for li in range(len(pl[0])):
        stack = torch.stack([p[li].float() for p in pl])
        masks = torch.stack([m[li].expand(p[li].shape).float()
                             for p, m in zip(pl, ml)])
        plain = stack.mean(dim=0)
        msum = masks.sum(dim=0)
        masked = (stack * masks).sum(dim=0) / msum.clamp_min(1e-12)
        masked = torch.where(msum > 1e-12, masked, plain)
        n_l = ((masked - plain) ** 2).sum()
        d_l = (plain ** 2).sum()
        num = n_l if num is None else num + n_l
        den = d_l if den is None else den + d_l
    return num / den.clamp_min(1e-30)


def eta_max(L: float, eps: float) -> float:          # noqa: N803
    """Largest admissible learning rate of Theorem 2."""
    return 2.0 / (L + L * eps + 4.0 * (eps + 1.0) * eps)


@dataclasses.dataclass(frozen=True)
class BoundInputs:
    L: float               # smoothness
    eta: float             # learning rate
    eps: float             # Assumption-3 epsilon
    sigma_sq_mean: float   # (1/N) sum sigma_n^2
    f0_minus_fstar: float  # F(W^0) - F(W*)
    h: int                 # full-broadcast period
    T: int                 # total rounds (T = K*h)


def theorem2_bound(b: BoundInputs) -> float:
    """Numerical RHS of Eq. (22); +inf where eta violates feasibility."""
    L, eta, eps, h = b.L, b.eta, b.eps, float(b.h)   # noqa: N806
    denom_core = (2.0 * eta - L * eta**2 - L * eps * eta**2
                  - 4.0 * (eps + 1.0) * eps * eta**2)
    if denom_core <= 0:
        return float("inf")
    term1 = 2.0 * b.f0_minus_fstar / (b.T * denom_core)
    poly = (2.0 * eps + 2.0 * eps * eta**2 * L**2
            + 2.0 * eta**2 * L**2 + 3.0)
    term2 = (L * eps * eta**2 * b.sigma_sq_mean * (h - 1.0) * poly
             / (h * denom_core))
    term3 = L * eps * eta**2 * b.sigma_sq_mean / (h * denom_core)
    return term1 + term2 + term3


def residual_error(b: BoundInputs) -> float:
    """Terms 2 and 3 of Eq. (22): the residual that does not vanish."""
    full = theorem2_bound(b)
    if full == float("inf"):
        return full
    return full - theorem2_bound(dataclasses.replace(b, eps=0.0, T=b.T))
