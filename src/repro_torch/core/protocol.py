"""FedDD training protocol — the paper's Algorithm 1 and the FedAvg baseline.

The driver orchestrates any model exposing

    local_train_fn(params, client_idx, key) -> (new_params, loss)
    eval_fn(params) -> metrics dict            (optional)

with the JAX package's key chain (:mod:`repro_torch.prng`, threefry):
``PRNGKey(ProtocolConfig.seed)``, split once a round into the carried key
and the round key ``rk``; client ``i`` trains under ``fold_in(rk, i)`` and
the engine step takes ``rk`` (random masks, int8 stochastic rounding).

Every round runs through the batched engine (``core/round_engine.py``):
the fleet's parameters stay stacked on the device, one engine step per
round.  Between rounds the numpy Eq. (9)-(11) LP re-allocates the dropout
rates (on effective wire bytes with ``comm.overhead_aware_allocation``)
and the Eq. (12) clock advances:

    t = t_cmp + U(1-D)/r_u + U(1-D)/r_d,   the round takes the max over
    participating clients, at the rates the round's uploads used; with a
    non-default wire format the uplink leg charges the codec's analytic
    bytes (``comm.payload.analytic_wire_bytes``).

Not ported yet, each raising with a pointer to ROADMAP.md queue A: the
per-client reference loop, ragged (grouped) fleets, the scanned
multi-round path, FedCS/Oort, the event-driven simulator with faults and
population serving, and the client-sharded mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import convert, prng, tree
from repro_torch.comm.payload import (CommConfig, WireSpec, account_uplink,
                                      analytic_uplink_vector)
from repro_torch.core import baselines, round_engine, selection
from repro_torch.core.allocation import (ALLOCATORS, AllocationResult,
                                         ClientTelemetry,
                                         solve_dropout_rates_with)
from repro_torch.device import DeviceLike, resolve_device

SCHEMES = ("feddd", "fedavg")


@dataclasses.dataclass
class ProtocolConfig:
    scheme: str = "feddd"            # feddd | fedavg
    selection: selection.SelectionConfig = dataclasses.field(
        default_factory=selection.SelectionConfig)
    a_server: float = 0.6            # communication budget (Table 4)
    d_max: float = 0.8               # max dropout rate (Table 4)
    delta: float = 1.0               # heterogeneity penalty factor
    h: int = 5                       # full-broadcast period (Table 4)
    rounds: int = 50
    seed: int = 0
    allocator: str = "numpy"         # Eq. (16)/(17) LP solver
    comm: CommConfig = dataclasses.field(default_factory=CommConfig)
                                     # wire format (repro_torch.comm); the
                                     # default is the analytic accounting

    def __post_init__(self):
        if self.scheme in ("fedcs", "oort"):
            raise NotImplementedError(
                f"scheme {self.scheme!r} is not ported yet (ROADMAP.md "
                "queue A item 7)")
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.allocator not in ALLOCATORS:
            raise NotImplementedError(
                f"allocator {self.allocator!r} is not ported yet (ROADMAP.md "
                "queue A item 4); use allocator='numpy'")


@dataclasses.dataclass
class RoundRecord:
    """One round of history.  ``sim_time`` / ``sim_round_time`` are the
    paper's SIMULATED Eq. (12) seconds; ``host_wall_time`` is the real
    seconds the host spent on the round (training + engine step + eval
    dispatch), never comparable to ``sim_time``."""

    round: int
    sim_time: float                  # cumulative simulated secs (Eq. 12)
    host_wall_time: float            # real host secs spent in this round
    mean_loss: float
    dropout_rates: np.ndarray        # rates allocated for the NEXT round
    uploaded_fraction: float         # raw kept bytes / full bytes
    participants: int
    sim_round_time: float = 0.0      # this round's simulated duration
    uploaded_bytes: float = 0.0      # raw kept-parameter mass (density x U)
    wire_bytes: float = 0.0          # on-wire uplink bytes: values at the
                                     # codec's precision + measured mask /
                                     # scale overhead; == uploaded_bytes
                                     # with the default CommConfig
    epsilon: Optional[float] = None  # Assumption-3 estimate (the JAX
                                     # package's reference loop only)
    metrics: Optional[Dict] = None
    # failure-model fields of the JAX package's simulator; the defaults
    # describe a fault-free round
    survivors: int = -1              # clients alive on the round clock
                                     # (-1: not tracked)
    retries: int = 0                 # uplink chunk retransmits
    abandoned_bytes: float = 0.0     # wire bytes sent but never used
    quarantined_bytes: float = 0.0   # wire bytes screened out of Eq. (4)
    skipped: bool = False            # quorum miss: global held, no step


@dataclasses.dataclass
class RunResult:
    history: List[RoundRecord]
    global_params: object

    def time_to_accuracy(self, target: float, key: str = "accuracy"
                         ) -> Optional[float]:
        for rec in self.history:
            if rec.metrics and rec.metrics.get(key, -1.0) >= target:
                return rec.sim_time
        return None


def _tree_bytes(params) -> int:
    return sum(l.numel() * l.element_size() for l in tree.leaves(params))


class _RoundData(NamedTuple):
    losses: np.ndarray               # server-side loss view after the round
    uploaded_bytes: float            # raw kept bytes uploaded this round
    active: np.ndarray               # (N,) bool: clients on the Eq. (12) clock
    wire_bytes: float


class _EngineExecutor:
    """One BatchedRoundEngine step per round; client state stays stacked
    on the device.  FedAvg runs ``dense_masks`` mode with
    non-participation as a 0 aggregation weight."""

    def __init__(self, server: "FedDDServer", local_train_fn):
        self.srv = server
        self.local_train_fn = local_train_fn
        self.engine = round_engine.BatchedRoundEngine(server.cfg.selection,
                                                      server.cfg.comm)
        self.weights = np.asarray(
            [int(s) for s in server.tel.num_samples], float)
        self.stacked = round_engine.stack_pytrees(
            [server.global_params] * server.tel.num_clients)

    def run_round(self, t: int, rk: np.ndarray, losses: np.ndarray,
                  d_used: np.ndarray) -> _RoundData:
        srv, cfg = self.srv, self.srv.cfg
        n = srv.tel.num_clients
        dense = cfg.scheme != "feddd"
        part = (np.ones(n, bool) if not dense
                else srv._participants(losses))
        new_list, loss_list = [], []
        for i, p_i in enumerate(round_engine.unstack_pytree(self.stacked, n)):
            if part[i]:
                p, l = self.local_train_fn(p_i, i, prng.fold_in(rk, i))
            else:       # baseline non-participant: stale state
                p, l = p_i, losses[i]
            new_list.append(p)
            loss_list.append(l)
        stacked_new = round_engine.stack_pytrees(new_list)
        out = self.engine.step(self.stacked, stacked_new, srv.global_params,
                               d_used, self.weights * part, rk,
                               full_round=(t % cfg.h == 0) or dense,
                               dense_masks=dense)
        srv.global_params = out.global_params
        self.stacked = out.client_params
        dens, oh = _to_host(out.densities, out.wire_overhead)
        new_losses = np.asarray([float(l) for l in loss_list], float)
        uploaded, wire = account_uplink(dens, part, srv.tel.model_bytes, oh,
                                        cfg.comm)
        return _RoundData(new_losses, uploaded, part, wire)


def _to_host(densities: torch.Tensor, wire_overhead):
    """The round's one device-to-host copy: the (N,) float32 densities and,
    with a non-default wire format, the (N,) int32 overhead (its bits ride
    in the same float32 buffer)."""
    if wire_overhead is None:
        return densities.cpu().numpy(), None
    n = densities.shape[0]
    both = torch.cat([densities, wire_overhead.view(torch.float32)])
    host = both.cpu().numpy()
    return host[:n], host[n:].view(np.int32)


class FedDDServer:
    """Parameter server for FedDD and the FedAvg baseline."""

    def __init__(self, global_params, cfg: ProtocolConfig,
                 telemetry: ClientTelemetry, client_params=None, *,
                 device: DeviceLike = None):
        if client_params is not None:
            raise NotImplementedError(
                "per-client (ragged) client_params need the grouped engine, "
                "not ported yet (ROADMAP.md queue A item 11)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tel = telemetry
        self.global_params = convert.to_torch(global_params, self.device)
        # per-client wire shapes: the analytic byte model behind the
        # Eq. (12) uplink charge and the overhead-aware allocation
        self.wire_specs = [WireSpec.from_params(
            self.global_params, cfg.selection.channel_axis)
        ] * telemetry.num_clients
        self.dropout = np.zeros(telemetry.num_clients)   # D_n^1 = 0
        self.rng = prng.PRNGKey(cfg.seed)

    def allocate(self, losses: np.ndarray) -> AllocationResult:
        tel = dataclasses.replace(self.tel, train_loss=losses)
        return solve_dropout_rates_with(
            self.cfg.allocator, tel,
            a_server=self.cfg.a_server, d_max=self.cfg.d_max,
            delta=self.cfg.delta,
            global_model_bytes=_tree_bytes(self.global_params),
            comm=self.cfg.comm, wire_specs=self.wire_specs)

    def _participants(self, losses: np.ndarray) -> np.ndarray:
        if self.cfg.scheme == "fedavg":
            return baselines.select_fedavg(self.tel)
        return np.ones(self.tel.num_clients, bool)   # feddd: everyone

    def run(self, local_train_fn: Callable,
            eval_fn: Optional[Callable[[object], Dict]] = None,
            rounds: Optional[int] = None) -> RunResult:
        cfg = self.cfg
        rounds = rounds or cfg.rounds
        n = self.tel.num_clients
        losses = np.ones(n)
        sim_time = 0.0
        history: List[RoundRecord] = []
        full_bytes = float(np.sum(self.tel.model_bytes))
        executor = _EngineExecutor(self, local_train_fn)
        for t in range(1, rounds + 1):
            t0 = time.perf_counter()
            self.rng, rk = prng.split(self.rng)
            d_used = self.dropout.copy()  # D_t: what uploads use
            rd = executor.run_round(t, rk, losses, d_used)
            losses = rd.losses
            # --- Step 5: dropout-rate allocation for round t+1
            if cfg.scheme == "feddd":
                alloc = self.allocate(np.maximum(losses, 1e-6))
                self.dropout = alloc.dropout_rates
            # --- simulated wall clock (paper Eq. (12))
            d_for_time = (d_used if cfg.scheme == "feddd"
                          else np.zeros(n))
            up = (None if cfg.comm.is_default else
                  analytic_uplink_vector(self.wire_specs, d_for_time,
                                         cfg.comm))
            t_all = baselines.round_times(self.tel, d_for_time,
                                          uplink_bytes=up)
            round_t = float(np.max(t_all[rd.active]))
            sim_time += round_t
            metrics = eval_fn(self.global_params) if eval_fn else None
            history.append(RoundRecord(
                round=t, sim_time=sim_time, sim_round_time=round_t,
                host_wall_time=time.perf_counter() - t0,
                mean_loss=float(np.mean(losses)),
                dropout_rates=self.dropout.copy(),
                uploaded_fraction=rd.uploaded_bytes / max(full_bytes, 1e-9),
                uploaded_bytes=rd.uploaded_bytes, wire_bytes=rd.wire_bytes,
                participants=int(np.sum(rd.active)),
                survivors=int(np.sum(rd.active)), metrics=metrics))
        return RunResult(history, self.global_params)


def run_scheme(scheme: str, global_params, telemetry, local_train_fn,
               eval_fn=None, client_params=None, *,
               device: DeviceLike = None, sim=None, network=None,
               faults=None, population=None, cohort_size=None, mesh=None,
               **cfg_kw) -> RunResult:
    """One-call wrapper: build the server for ``scheme`` and run it.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` for a CPU run.  The simulator (``sim`` / ``network``
    / ``faults``), population serving and the client-sharded mesh are not
    ported yet.
    """
    if sim is not None or network is not None or faults is not None:
        raise NotImplementedError(
            "the event-driven simulator and fault layer are not ported yet "
            "(ROADMAP.md queue A item 13)")
    if population is not None or cohort_size is not None:
        raise NotImplementedError(
            "population serving is not ported yet (ROADMAP.md queue A "
            "item 13)")
    if mesh is not None:
        raise NotImplementedError(
            "the client-sharded mesh is not ported yet (ROADMAP.md queue A "
            "item 14)")
    cfg = ProtocolConfig(scheme=scheme, **cfg_kw)
    server = FedDDServer(global_params, cfg, telemetry, client_params,
                         device=device)
    return server.run(local_train_fn, eval_fn)
