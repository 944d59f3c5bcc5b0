"""Dropout-rate allocation — FedDD §4.1, the port of
``repro.core.allocation``.

Solves the linear program Eq. (16)/(17):

    min_{D, t_srv}   t_srv + delta * sum_n re_n * D_n
    s.t.             0 <= D_n <= D_max
                     sum_n U_n (1 - D_n) = A_server * sum_n U_n
                     t_n_cmp + U_n (1 - D_n) * (1/r_u + 1/r_d) <= t_srv

For a fixed ``t_srv`` the straggler constraints are per-client lower
bounds on ``D_n`` and the rest is a fractional knapsack, solved exactly;
a golden-section search over ``t_srv`` finds the optimum of the convex
piecewise-linear outer problem.  Two solvers, named as the JAX
package's ``ALLOCATORS`` so configurations carry over:

* ``"numpy"``: float64 numpy, the same arithmetic as the JAX package's
  reference solver, so the rates agree exactly
  (tests/test_torch_selection_aggregation.py);
* ``"jax"``: :func:`solve_dropout_rates_torch`, the float32
  golden-section twin of ``solve_dropout_rates_jax`` in torch on the
  server's device, with no host sync, so the scanned multi-round engine
  (``core/round_engine.BatchedRoundEngine.run``) runs it between rounds.
  Its rates are within 5e-5 of the JAX package's solver (the bracket
  lands a few ulps apart; tests/test_torch_scan.py); between the port's
  per-round and scanned paths they are bit-equal (the same eager
  operations on the same device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.comm.payload import analytic_uplink_vector
from repro_torch.device import DeviceLike, resolve_device

ALLOCATORS = ("numpy", "jax")


@dataclasses.dataclass(frozen=True)
class ClientTelemetry:
    """Per-client state the server needs to run the allocation LP.

    All arrays have shape ``(N,)`` for N clients.
    """

    model_bytes: np.ndarray        # U_n   — size of client n's local model
    uplink_rate: np.ndarray        # r_n^u — bytes / s
    downlink_rate: np.ndarray      # r_n^d — bytes / s
    compute_latency: np.ndarray    # t_n^cmp — seconds (c_n * b_n / f_n)
    num_samples: np.ndarray        # m_n
    label_coverage: np.ndarray     # sum_c min(C * dis_n^c, 1)   (Eq. 13 term)
    train_loss: np.ndarray         # loss_n^t

    def __post_init__(self):
        n = len(self.model_bytes)
        for f in dataclasses.fields(self):
            arr = getattr(self, f.name)
            if len(arr) != n:
                raise ValueError(
                    f"telemetry field {f.name} has length {len(arr)} != {n}")

    @property
    def num_clients(self) -> int:
        return len(self.model_bytes)

    def subset(self, indices) -> "ClientTelemetry":
        """Telemetry restricted to a client subset (boolean mask or index
        array): the survivor-only LP re-solves of the simulator's fault
        layer and a population's cohort rows."""
        idx = np.asarray(indices)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        return ClientTelemetry(**{
            f.name: np.asarray(getattr(self, f.name))[idx]
            for f in dataclasses.fields(self)
        })


def regularizer(tel: ClientTelemetry, global_model_bytes: float) -> np.ndarray:
    """``re_n`` of Eq. (13): (m_n/m) * coverage * (U_n/U) * loss_n."""
    m = float(np.sum(tel.num_samples))
    return (
        (tel.num_samples / m)
        * tel.label_coverage
        * (tel.model_bytes / float(global_model_bytes))
        * tel.train_loss
    )


@dataclasses.dataclass(frozen=True)
class AllocationResult:
    dropout_rates: np.ndarray   # D_n in [0, D_max]
    t_server: float             # optimal round time (straggler makespan)
    objective: float            # t_server + delta * sum re_n D_n
    feasible: bool


def _inner_knapsack(
    lower: np.ndarray,
    upper: np.ndarray,
    weights: np.ndarray,   # U_n  (budget is in units of sum U_n D_n)
    costs: np.ndarray,     # c_n = delta * re_n  (cost per unit of D_n)
    budget: float,         # required sum_n U_n D_n
) -> Tuple[Optional[np.ndarray], float]:
    """Exactly minimise sum c_n D_n  s.t.  lower<=D<=upper, sum U_n D_n = budget.

    Returns (D, cost) or (None, inf) when infeasible.
    """
    lo_mass = float(np.dot(weights, lower))
    hi_mass = float(np.dot(weights, upper))
    if budget < lo_mass - 1e-9 or budget > hi_mass + 1e-9:
        return None, float("inf")
    d = lower.astype(np.float64).copy()
    remaining = budget - lo_mass
    if remaining <= 1e-12:
        return d, float(np.dot(costs, d))
    # marginal cost of one unit of U*D mass for client n is costs_n/weights_n
    order = np.argsort(costs / np.maximum(weights, 1e-30))
    for i in order:
        cap = (upper[i] - d[i]) * weights[i]
        take = min(cap, remaining)
        if take > 0:
            d[i] += take / weights[i]
            remaining -= take
        if remaining <= 1e-12:
            break
    if remaining > 1e-6 * max(budget, 1.0):
        return None, float("inf")
    return d, float(np.dot(costs, d))


def solve_dropout_rates(
    tel: ClientTelemetry,
    *,
    a_server: float,
    d_max: float,
    delta: float,
    global_model_bytes: Optional[float] = None,
    tol: float = 1e-7,
) -> AllocationResult:
    """Exact numpy solver for the Eq. (16)/(17) LP.

    Args:
      a_server: fraction of total parameter mass the server requires
        (``A_server``); the equality budget is ``(1-a_server) * sum U_n`` of
        *dropped* mass.
      d_max: per-client max dropout rate (``D_max``).
      delta: penalty factor balancing system vs data/model heterogeneity.
    """
    if not 0.0 <= a_server <= 1.0:
        raise ValueError(f"a_server must be in [0,1], got {a_server}")
    if not 0.0 <= d_max <= 1.0:
        raise ValueError(f"d_max must be in [0,1], got {d_max}")
    u = tel.model_bytes.astype(np.float64)
    n = tel.num_clients
    gmb = float(global_model_bytes if global_model_bytes is not None
                else np.max(u))
    re = regularizer(tel, gmb)
    costs = delta * re
    k = u * (1.0 / tel.uplink_rate + 1.0 / tel.downlink_rate)  # secs at D=0
    tc = tel.compute_latency.astype(np.float64)

    total_u = float(np.sum(u))
    budget = (1.0 - a_server) * total_u  # required dropped mass sum U_n D_n

    upper = np.full(n, d_max)

    # Feasible interval of t_srv: at t_lo every client drops D_max (the
    # tightest makespan); at t_hi nothing is dropped.
    t_lo = float(np.max(tc + k * (1.0 - d_max)))
    t_hi = float(np.max(tc + k))

    def inner(t_srv: float) -> Tuple[Optional[np.ndarray], float]:
        # straggler constraint lower bound on D_n
        with np.errstate(divide="ignore", invalid="ignore"):
            l = 1.0 - (t_srv - tc) / np.maximum(k, 1e-30)
        l = np.clip(l, 0.0, None)
        if np.any(l > d_max + 1e-12):
            return None, float("inf")
        l = np.minimum(l, d_max)
        d, cost = _inner_knapsack(l, upper, u, costs, budget)
        if d is None:
            return None, float("inf")
        return d, t_srv + cost

    # Budget feasibility is independent of t_srv at t_hi; check once.
    d0, f_hi = inner(t_hi)
    if d0 is None:
        return AllocationResult(np.clip(np.full(n, 1 - a_server), 0, d_max),
                                t_hi, float("inf"), False)

    # Golden-section search on the convex piecewise-linear objective.
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = t_lo, t_hi
    # infeasible low end: bisect up to feasibility first
    _, f_a = inner(a)
    if not np.isfinite(f_a):
        lo, hi = a, b
        for _ in range(100):
            mid = 0.5 * (lo + hi)
            _, fm = inner(mid)
            if np.isfinite(fm):
                hi = mid
            else:
                lo = mid
        a = hi
    c = b - gr * (b - a)
    d_pt = a + gr * (b - a)
    _, fc = inner(c)
    _, fd = inner(d_pt)
    it = 0
    while (b - a) > tol * max(1.0, abs(b)) and it < 200:
        if fc <= fd:
            b, d_pt, fd = d_pt, c, fc
            c = b - gr * (b - a)
            _, fc = inner(c)
        else:
            a, c, fc = c, d_pt, fd
            d_pt = a + gr * (b - a)
            _, fd = inner(d_pt)
        it += 1
    t_star = 0.5 * (a + b)
    d_star, f_star = inner(t_star)
    if d_star is None:   # numerical edge: fall back to safe end
        d_star, f_star = d0, f_hi
        t_star = t_hi
    # The true makespan may be below t_star if constraints are slack.
    makespan = float(np.max(tc + k * (1.0 - d_star)))
    obj = makespan + float(np.dot(costs, d_star))
    return AllocationResult(d_star, makespan, obj, True)


def solve_dropout_rates_overhead_aware(
    tel: ClientTelemetry,
    wire_specs,
    *,
    comm,
    a_server: float,
    d_max: float,
    delta: float,
    global_model_bytes: Optional[float] = None,
    num_refinements: int = 4,
) -> AllocationResult:
    """Eq. (16)/(17) on EFFECTIVE on-wire bytes instead of the linear proxy.

    On a real wire client n's upload is ``B_n(D) = values(D) * qbits/32 +
    mask_overhead(D)`` (``comm.payload.analytic_wire_bytes``), nonlinear
    in D.  Each refinement linearises around the current solution: the
    per-client byte weight becomes ``U_eff,n = B_n(D_n) / (1 - D_n)`` and
    ``a_server`` is rescaled so the budget binds on wire bytes,
    ``sum_n B_n(D_n) = A_server * sum_n B_n(0)``; the Eq. (13)
    regularizer's (U_n/U) term and the downlink leg are compensated so
    only the uplink mass changes.  The JAX package's algorithm, in the
    same float64 numpy.

    Args:
      wire_specs: one ``comm.payload.WireSpec`` per client.
      comm: the ``comm.payload.CommConfig`` whose byte model to use.
    """
    n = tel.num_clients
    result = solve_dropout_rates(tel, a_server=a_server, d_max=d_max,
                                 delta=delta,
                                 global_model_bytes=global_model_bytes)
    wire_full = analytic_uplink_vector(wire_specs, np.zeros(n), comm)
    total_full = float(np.sum(wire_full))
    u_raw = tel.model_bytes.astype(np.float64)
    for _ in range(num_refinements):
        d = np.clip(result.dropout_rates, 0.0, d_max)
        keep = np.maximum(1.0 - d, 1e-6)
        u_eff = analytic_uplink_vector(wire_specs, d, comm) / keep
        a_eff = float(np.clip(a_server * total_full / max(
            float(np.sum(u_eff)), 1e-30), 0.0, 1.0))
        ratio = u_eff / np.maximum(u_raw, 1e-30)
        tel_eff = dataclasses.replace(
            tel, model_bytes=np.asarray(u_eff, np.float64),
            train_loss=tel.train_loss / np.maximum(ratio, 1e-30),
            downlink_rate=tel.downlink_rate * ratio)
        result = solve_dropout_rates(
            tel_eff, a_server=a_eff, d_max=d_max, delta=delta,
            global_model_bytes=global_model_bytes)
    d = np.clip(result.dropout_rates, 0.0, d_max)
    wire = analytic_uplink_vector(wire_specs, d, comm)
    # the makespan the WIRE sees (uplink = codec bytes)
    u_eff_dl = tel.model_bytes.astype(np.float64) * (1.0 - d)
    makespan = float(np.max(tel.compute_latency + wire / tel.uplink_rate
                            + u_eff_dl / tel.downlink_rate))
    gmb = float(global_model_bytes if global_model_bytes is not None
                else np.max(tel.model_bytes))
    obj = makespan + delta * float(np.dot(regularizer(tel, gmb), d))
    feasible = bool(abs(float(np.sum(wire)) - a_server * total_full)
                    <= 5e-2 * max(total_full, 1.0))
    return AllocationResult(d, makespan, obj, feasible)


# ---------------------------------------------------------------------------
# The float32 twin of the JAX package's jit-able solver: eager torch on one
# device, no host sync (every branch is a torch.where), so a scanned chunk
# of rounds runs it between rounds.
# ---------------------------------------------------------------------------

_GR = float((np.sqrt(np.float32(5.0)) - np.float32(1.0)) / np.float32(2.0))


def stage(x, device) -> torch.Tensor:
    """A host telemetry vector as a float32 tensor on ``device`` (numpy's
    rounding of float64 to float32, as ``jnp.asarray(x, jnp.float32)``)."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _inner_knapsack_torch(lower, upper, weights, w_safe, costs, budget,
                          hi_mass, order):
    """Vectorised fractional knapsack, (N,) float32 throughout -> (d, cost,
    feasible).  ``order`` (the argsort of costs / weights), ``hi_mass``
    and ``w_safe = max(weights, 1e-30)`` do not depend on the bracket, so
    the caller computes them once."""
    lo_mass = torch.dot(weights, lower)
    feasible = (budget >= lo_mass - 1e-9) & (budget <= hi_mass + 1e-9)
    remaining = torch.clamp(budget - lo_mass, min=0.0)
    caps = ((upper - lower) * weights)[order]        # mass capacity, sorted
    prev = torch.cumsum(caps, 0) - caps
    take_sorted = torch.minimum(torch.clamp(remaining - prev, min=0.0), caps)
    take = torch.zeros_like(take_sorted).scatter_(0, order, take_sorted)
    d = lower + take / w_safe
    return d, torch.dot(costs, d), feasible


def solve_dropout_rates_torch(
    model_bytes: torch.Tensor,
    uplink_rate: torch.Tensor,
    downlink_rate: torch.Tensor,
    compute_latency: torch.Tensor,
    num_samples: torch.Tensor,
    label_coverage: torch.Tensor,
    train_loss: torch.Tensor,
    *,
    a_server: float,
    d_max: float,
    delta: float,
    global_model_bytes: Optional[float] = None,
    num_iters: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The golden-section solver of ``solve_dropout_rates_jax`` in float32
    torch: inputs are (N,) float32 tensors on one device; returns
    (dropout_rates, makespan) as tensors there, unclipped, with no host
    sync — ``num_iters`` bracket updates of a Python loop, each a
    ``torch.where``.  The argsort of costs / U and the other quantities
    that do not depend on the bracket are computed once, before the loop.
    About 80 device operations an iteration, so ~7.7k launches at the
    protocol's 96 (``PERF.md`` §5 has the measured count and time).
    """
    u = model_bytes
    gmb = torch.max(u) if global_model_bytes is None else global_model_bytes
    m = torch.sum(num_samples)
    re = (num_samples / m) * label_coverage * (u / gmb) * train_loss
    costs = delta * re
    k = u * (1.0 / uplink_rate + 1.0 / downlink_rate)
    tc = compute_latency
    budget = (1.0 - a_server) * torch.sum(u)
    upper = torch.full_like(u, d_max)
    big = torch.full((), 1e30, dtype=torch.float32, device=u.device)
    k_safe = torch.clamp(k, min=1e-30)
    w_safe = torch.clamp(u, min=1e-30)
    order = torch.argsort(costs / w_safe, stable=True)
    hi_mass = torch.dot(u, upper)

    def inner_obj(t_srv):
        l = torch.clamp(1.0 - (t_srv - tc) / k_safe, min=0.0)
        bad = torch.any(l > d_max + 1e-12)
        l = torch.clamp(l, max=d_max)
        d, cost, feas = _inner_knapsack_torch(l, upper, u, w_safe, costs,
                                              budget, hi_mass, order)
        return torch.where(bad | ~feas, big, t_srv + cost), d

    a = torch.max(tc + k * (1.0 - d_max))
    b = torch.max(tc + k)
    for _ in range(num_iters):
        step = _GR * (b - a)
        c = b - step
        dd = a + step
        fc, _ = inner_obj(c)
        fd, _ = inner_obj(dd)
        # strict '<': when both probes are infeasible (equal sentinels, only
        # at the low end) the bracket shrinks from the left, toward
        # feasibility
        left = fc < fd
        a, b = torch.where(left, a, c), torch.where(left, dd, b)
    _, d_star = inner_obj(0.5 * (a + b))
    return d_star, torch.max(tc + k * (1.0 - d_star))


def solve_dropout_rates_with(
    allocator: str,
    tel: ClientTelemetry,
    *,
    a_server: float,
    d_max: float,
    delta: float,
    global_model_bytes: Optional[float] = None,
    comm=None,
    wire_specs=None,
    num_iters: int = 96,
    device: DeviceLike = None,
) -> AllocationResult:
    """Allocator dispatch: ``"numpy"``, the float64 LP (with ``comm``'s
    ``overhead_aware_allocation``, :func:`solve_dropout_rates_overhead_aware`
    over ``wire_specs``), or ``"jax"``, the float32 golden-section twin
    :func:`solve_dropout_rates_torch` on ``device`` (default ``cuda``) —
    the scanned engine's solver, run on the same device so per-round and
    scanned rates agree bit for bit.  Either way a host
    :class:`AllocationResult`: for "jax" the rates clipped in float64, the
    device makespan, the objective, and ``feasible`` when the budget
    equality holds within 1e-4 of the total bytes."""
    kw = dict(a_server=a_server, d_max=d_max, delta=delta,
              global_model_bytes=global_model_bytes)
    aware = comm is not None and comm.overhead_aware_allocation
    if allocator == "numpy":
        if aware:
            return solve_dropout_rates_overhead_aware(tel, wire_specs,
                                                      comm=comm, **kw)
        return solve_dropout_rates(tel, **kw)
    if allocator != "jax":
        raise ValueError(f"unknown allocator {allocator!r}; "
                         f"expected one of {ALLOCATORS}")
    if aware:
        raise ValueError("comm.overhead_aware_allocation is a host-side "
                         "fixed point around the numpy LP; it requires "
                         "allocator='numpy'")
    dev = resolve_device(device)
    d_dev, t_dev = solve_dropout_rates_torch(
        *(stage(getattr(tel, f), dev) for f in (
            "model_bytes", "uplink_rate", "downlink_rate", "compute_latency",
            "num_samples", "label_coverage", "train_loss")),
        num_iters=num_iters, **kw)
    host = torch.cat([t_dev.view(1), d_dev]).cpu().numpy()   # one transfer
    d = np.clip(host[1:].astype(np.float64), 0.0, d_max)
    u = tel.model_bytes.astype(np.float64)
    gmb = float(global_model_bytes if global_model_bytes is not None
                else np.max(u))
    obj = float(host[0]) + delta * float(np.dot(regularizer(tel, gmb), d))
    budget = (1.0 - a_server) * float(np.sum(u))
    feasible = bool(abs(float(np.dot(u, d)) - budget)
                    <= 1e-4 * max(float(np.sum(u)), 1.0))
    return AllocationResult(d, float(host[0]), obj, feasible)
