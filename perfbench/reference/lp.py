"""A frozen copy of FedDD's dropout-rate LP, Eq. (9)-(11) as the linear
program Eq. (16)/(17), in float64 numpy:

    min_{D, t}  t + delta * sum_n re_n D_n
    s.t.        0 <= D_n <= D_max,   sum_n U_n (1 - D_n) = A_server sum_n U_n,
                t_n^cmp + U_n (1 - D_n) (1/r_u + 1/r_d) <= t,

re_n = (m_n / m) * coverage_n * (U_n / U) * loss_n (Eq. (13)).  For a
fixed t the straggler constraints bound each D_n below and the rest is a
fractional knapsack, solved exactly; a golden-section search over t
finds the optimum of the convex piecewise-linear outer problem."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _knapsack(lower, upper, weights, costs, budget
              ) -> Tuple[Optional[np.ndarray], float]:
    lo_mass = float(np.dot(weights, lower))
    hi_mass = float(np.dot(weights, upper))
    if budget < lo_mass - 1e-9 or budget > hi_mass + 1e-9:
        return None, float("inf")
    d = lower.astype(np.float64).copy()
    remaining = budget - lo_mass
    if remaining <= 1e-12:
        return d, float(np.dot(costs, d))
    for i in np.argsort(costs / np.maximum(weights, 1e-30)):
        take = min((upper[i] - d[i]) * weights[i], remaining)
        if take > 0:
            d[i] += take / weights[i]
            remaining -= take
        if remaining <= 1e-12:
            break
    if remaining > 1e-6 * max(budget, 1.0):
        return None, float("inf")
    return d, float(np.dot(costs, d))


def dropout_rates(tel: Dict[str, np.ndarray], losses: np.ndarray, *,
                  a_server: float, d_max: float, delta: float,
                  global_model_bytes: float, tol: float = 1e-7
                  ) -> np.ndarray:
    """D_n for the next round, given this round's training losses."""
    u = np.asarray(tel["model_bytes"], np.float64)
    n = len(u)
    samples = np.asarray(tel["num_samples"], np.float64)
    re = ((samples / samples.sum()) * tel["label_coverage"]
          * (u / float(global_model_bytes)) * losses)
    costs = delta * re
    k = u * (1.0 / tel["uplink_rate"] + 1.0 / tel["downlink_rate"])
    tc = np.asarray(tel["compute_latency"], np.float64)
    budget = (1.0 - a_server) * float(np.sum(u))
    upper = np.full(n, d_max)
    t_lo = float(np.max(tc + k * (1.0 - d_max)))
    t_hi = float(np.max(tc + k))

    def inner(t):
        with np.errstate(divide="ignore", invalid="ignore"):
            low = 1.0 - (t - tc) / np.maximum(k, 1e-30)
        low = np.clip(low, 0.0, None)
        if np.any(low > d_max + 1e-12):
            return None, float("inf")
        d, cost = _knapsack(np.minimum(low, d_max), upper, u, costs, budget)
        return (None, float("inf")) if d is None else (d, t + cost)

    d0, _ = inner(t_hi)
    if d0 is None:
        return np.clip(np.full(n, 1 - a_server), 0, d_max)
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = t_lo, t_hi
    if not np.isfinite(inner(a)[1]):
        lo, hi = a, b
        for _ in range(100):
            mid = 0.5 * (lo + hi)
            if np.isfinite(inner(mid)[1]):
                hi = mid
            else:
                lo = mid
        a = hi
    c = b - gr * (b - a)
    dp = a + gr * (b - a)
    fc, fd = inner(c)[1], inner(dp)[1]
    it = 0
    while (b - a) > tol * max(1.0, abs(b)) and it < 200:
        if fc <= fd:
            b, dp, fd = dp, c, fc
            c = b - gr * (b - a)
            fc = inner(c)[1]
        else:
            a, c, fc = c, dp, fd
            dp = a + gr * (b - a)
            fd = inner(dp)[1]
        it += 1
    d_star, _ = inner(0.5 * (a + b))
    return d0 if d_star is None else d_star
