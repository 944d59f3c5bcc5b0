"""FedDD training protocol — the paper's Algorithm 1 and the FedAvg baseline.

The driver orchestrates any model exposing

    local_train_fn(params, client_idx, key) -> (new_params, loss)
      or batched_train_fn(stacked_params, key) -> (stacked_params, (N,) losses)
    eval_fn(params) -> metrics dict            (optional)

with the JAX package's key chain (:mod:`repro_torch.prng`, threefry):
``PRNGKey(ProtocolConfig.seed)``, split once a round into the carried key
and the round key ``rk``; client ``i`` trains under ``fold_in(rk, i)`` and
the engine step takes ``rk`` (random masks, int8 stochastic rounding).

Round execution is a strategy behind one executor interface
(:class:`_RoundExecutor`); every strategy runs the same Algorithm-1 maths:

* **engine** (default): the fleet's parameters stay stacked on the
  device, one engine step per round (``core/round_engine.py``).  FedAvg,
  FedCS and Oort run its ``dense_masks`` mode with non-participants as a
  0 aggregation weight.  With ``batched_train_fn`` (e.g.
  ``round_engine.make_batched_train_fn``) local training is one fused
  call for every client too, and the round's losses reach the host in
  its one transfer.
* **scanned** (``rounds_per_dispatch=K > 1``, with ``batched_train_fn``
  and ``allocator="jax"``): K whole rounds per
  ``BatchedRoundEngine.run`` call, the allocation and the clock on the
  device between them, one host transfer per chunk; the records are
  spliced back per round and equal the per-round path's bit for bit.
* **grouped** (a ragged fleet: ``client_params`` whose sub-models differ
  in width from the global model): clients are partitioned by sub-model
  shape (``fl.heterogeneity.group_by_shape``), each group stays stacked
  on the device across rounds, and one ``GroupedRoundEngine`` step a
  round runs coverage-aware masks per group (Eq. (21)), Eq. (4) on the
  full-width canvas and Eq. (5) per group at local widths.  It equals
  the loop on the same fleet bit for bit.
* **sharded** (``mesh=``, a homogeneous fleet): the engine's flow with a
  ``ShardedRoundEngine`` step a round over a 1-D client mesh
  (:mod:`repro_torch.launch.mesh`: an int or ``True`` clamps to the
  visible devices of the server's type, one on the CPU; a ``ClientMesh``
  may repeat one device as virtual shards).  The shards exchange only
  the Eq. (4) partials, densely or compacted (``mesh_collective``,
  ``mesh_keep_fraction``), and ``account_collective`` counts those bytes
  once a round.  A ragged fleet with ``mesh=`` shards each group's
  member axis in the grouped engine.
* **loop** (``batched=False``, or ``track_epsilon=True``): the per-client
  reference loop, Algorithm 1 written out client by client — the oracle
  every engine is held to, and the only path that gives
  ``RoundRecord.epsilon`` (the Assumption-3 estimate,
  ``core/convergence.py``).  Slow by design: per-client mask building and
  Eq. (5) launches, and one density read (a device sync) per client.  On
  a ragged fleet each client scores its own widths with its coverage
  slice, its upload and mask are zero-padded to global widths for
  Eq. (4), and it takes Eq. (5)/(6) against the global sliced to its
  widths.

Between rounds the Eq. (9)-(11) LP re-allocates the dropout rates — the
numpy solver (on effective wire bytes with
``comm.overhead_aware_allocation``), or with ``allocator="jax"`` its
float32 torch twin on the server's device — and the Eq. (12) clock
advances:

    t = t_cmp + U(1-D)/r_u + U(1-D)/r_d,   the round takes the max over
    participating clients, at the rates the round's uploads used; with a
    non-default wire format the uplink leg charges the codec's analytic
    bytes (``comm.payload.analytic_wire_bytes``).

Observability (``ProtocolConfig.obs``, :mod:`repro_torch.obs`): host spans
around each phase (allocate / local_train / engine_step / host_transfer /
eval on the engine; local_train / encode / aggregate / client_update on
the loop), byte counters from ``account_uplink`` and one JSONL ``round``
event a round.  The default ``ObsConfig()`` is inert; spans read the
host clock only, so a run with obs on makes the same device syncs.

``robust_agg`` ("trimmed[:beta]", "clip[:factor]") hardens Eq. (4) on
the engine and grouped paths.

Crash-resume (``checkpoint_every=K`` + ``checkpoint_path``, and
``resume_from``; :mod:`repro_torch.checkpoint`): the engine and loop
executors snapshot everything round t+1 reads every K completed rounds,
atomically, and a resumed run continues bit for bit; the grouped and
scanned paths raise, as the JAX package's do.  ``run_scheme`` with
``sim=`` / ``network=`` / ``faults=`` / ``population=`` routes to the
event-driven simulator (:mod:`repro_torch.sim`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import convert, prng, tree
from repro_torch import obs as obs_mod
from repro_torch.comm import codecs as wire_codecs
from repro_torch.comm import quantize as wire_quant
from repro_torch.comm.payload import (CommConfig, WireSpec,
                                      account_collective, account_uplink,
                                      analytic_uplink_vector)
from repro_torch.core import (aggregation, allocation, baselines,
                              round_engine, selection)
from repro_torch.core import coverage as cov_mod
from repro_torch.core.allocation import (ALLOCATORS, AllocationResult,
                                         ClientTelemetry,
                                         solve_dropout_rates_with)
from repro_torch.core.convergence import estimate_epsilon
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import resolve_client_mesh

SCHEMES = ("feddd", "fedavg", "fedcs", "oort")


@dataclasses.dataclass
class ProtocolConfig:
    scheme: str = "feddd"            # feddd | fedavg | fedcs | oort
    selection: selection.SelectionConfig = dataclasses.field(
        default_factory=selection.SelectionConfig)
    a_server: float = 0.6            # communication budget (Table 4)
    d_max: float = 0.8               # max dropout rate (Table 4)
    delta: float = 1.0               # heterogeneity penalty factor
    h: int = 5                       # full-broadcast period (Table 4)
    rounds: int = 50
    seed: int = 0
    track_epsilon: bool = False      # Assumption-3 estimator (the loop)
    batched: bool = True             # False: the per-client reference loop
    allocator: str = "numpy"         # Eq. (16)/(17) LP solver: "numpy"
                                     # (float64) or "jax" (the float32
                                     # torch golden-section twin, on the
                                     # server's device)
    comm: CommConfig = dataclasses.field(default_factory=CommConfig)
                                     # wire format (repro_torch.comm); the
                                     # default is the analytic accounting
    obs: obs_mod.ObsConfig = dataclasses.field(
        default_factory=obs_mod.ObsConfig)
                                     # observability (repro_torch.obs); the
                                     # default is inert
    rounds_per_dispatch: int = 1     # K > 1: the scanned path (needs
                                     # allocator="jax")
    robust_agg: str = "mean"         # Eq. (4) variant: "mean",
                                     # "trimmed[:beta]", "clip[:factor]"
    mesh: object = None              # client-sharded rounds: an int
                                     # device count, True (every visible
                                     # device of the server's type), or a
                                     # launch.mesh.ClientMesh with a
                                     # "clients" axis; None: one device
    mesh_collective: str = "dense"   # cross-shard Eq. (4) reduction:
                                     # "dense" sum (exact) or "sparse"
                                     # compacted top-K channel exchange
                                     # (core/sparse_collective.py)
    mesh_keep_fraction: float = 1.0  # sparse collective buffer:
                                     # K = ceil(C * fraction) channels per
                                     # shard
    checkpoint_every: Optional[int] = None
                                     # crash-resume: snapshot the run every
                                     # K completed rounds (None: never)
    checkpoint_path: Optional[str] = None
                                     # where the snapshot lands (one file
                                     # pair, replaced atomically each save)
    resume_from: Optional[str] = None
                                     # a snapshot to continue from, at its
                                     # round + 1, bit for bit
    population: Optional[int] = None
                                     # population serving: the size of the
                                     # population the simulator samples
                                     # cohorts from (None: the fleet is it)
    cohort_size: Optional[int] = None
                                     # clients per round in population mode

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.allocator not in ALLOCATORS:
            raise ValueError(f"unknown allocator {self.allocator!r}; "
                             f"expected one of {ALLOCATORS}")
        if self.rounds_per_dispatch < 1:
            raise ValueError("rounds_per_dispatch must be >= 1, got "
                             f"{self.rounds_per_dispatch}")
        if self.rounds_per_dispatch > 1 and self.allocator != "jax":
            raise ValueError(
                "rounds_per_dispatch > 1 runs the dropout-rate allocation on "
                "the device between rounds and therefore requires "
                "allocator='jax' (the numpy LP runs on the host)")
        if self.comm.overhead_aware_allocation and self.allocator != "numpy":
            raise ValueError(
                "comm.overhead_aware_allocation is a host-side fixed point "
                "around the numpy LP; it requires allocator='numpy' (and "
                "therefore cannot ride rounds_per_dispatch > 1)")
        if self.mesh is not None and self.rounds_per_dispatch > 1:
            raise ValueError(
                "mesh (client-sharded rounds) and rounds_per_dispatch > 1 "
                "are mutually exclusive: the multi-round chunk carries "
                "single-device state")
        if self.mesh_collective not in ("dense", "sparse"):
            raise ValueError(f"mesh_collective must be 'dense' or "
                             f"'sparse', got {self.mesh_collective!r}")
        if not 0.0 < self.mesh_keep_fraction <= 1.0:
            raise ValueError(f"mesh_keep_fraction must be in (0,1], got "
                             f"{self.mesh_keep_fraction}")
        aggregation.parse_robust_agg(self.robust_agg)    # validate the spec
        if self.checkpoint_every is not None:
            if self.checkpoint_every < 1:
                raise ValueError("checkpoint_every must be >= 1 (or None "
                                 f"to disable), got {self.checkpoint_every}")
            if not self.checkpoint_path:
                raise ValueError("checkpoint_every requires "
                                 "checkpoint_path: somewhere for the "
                                 "RunState snapshot to land")
        if ((self.checkpoint_every is not None or self.resume_from)
                and self.rounds_per_dispatch > 1):
            raise ValueError(
                "checkpointing / resume operates at per-round dispatch "
                "boundaries; rounds_per_dispatch > 1 keeps rounds on the "
                "device in one chunk and has no boundary to snapshot at")
        if self.cohort_size is not None and self.population is None:
            raise ValueError("cohort_size requires population= (the "
                             "fleet IS the cohort otherwise)")
        if self.population is not None:
            if self.population < 1:
                raise ValueError(f"population must be >= 1, got "
                                 f"{self.population}")
            k = self.cohort_size
            if k is not None and not 1 <= k <= self.population:
                raise ValueError(f"cohort_size {k} outside [1, "
                                 f"{self.population}]")


@dataclasses.dataclass
class ClientState:
    params: object                   # W_n^t
    num_samples: int                 # m_n, the client's Eq. (4) weight


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
    epsilon: Optional[float] = None  # Assumption-3 estimate (the
                                     # reference loop with track_epsilon)
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
    epsilon: Optional[float]         # Assumption-3 estimate (loop only)
    wire_bytes: float


class _RoundExecutor:
    """One round-execution strategy: the server's :meth:`FedDDServer.run`
    owns the key schedule, the LP, the Eq. (12) clock and the history, and
    hands the round's training, masks, aggregation and client updates to
    one of these."""

    def __init__(self, server: "FedDDServer", local_train_fn,
                 batched_train_fn=None):
        self.srv = server
        self.local_train_fn = local_train_fn
        self.batched_train_fn = batched_train_fn

    def run_round(self, t: int, rk: np.ndarray, losses: np.ndarray,
                  d_used: np.ndarray) -> _RoundData:
        raise NotImplementedError

    def finalize(self) -> None:
        """Sync executor-held client state back into ``server.clients``."""

    # -- crash-resume hooks (repro_torch.checkpoint) ------------------------

    def snapshot_arrays(self):
        """The executor-held client state as a checkpointable pytree."""
        raise NotImplementedError(
            "checkpointing / resume supports the batched-engine and "
            "reference-loop executors; grouped runs hold per-group device "
            "state this snapshot does not capture")

    def restore_arrays(self, arrays) -> None:
        raise NotImplementedError


class _EngineExecutor(_RoundExecutor):
    """One BatchedRoundEngine step per round (or one ``run`` per chunk of
    rounds); client state stays stacked on the device.  The baselines run
    ``dense_masks`` mode with non-participation as a 0 aggregation
    weight; a fused trainer trains every row, so non-participants go back
    to their stale params and losses."""

    def __init__(self, server: "FedDDServer", local_train_fn,
                 batched_train_fn=None):
        super().__init__(server, local_train_fn, batched_train_fn)
        self.engine = round_engine.BatchedRoundEngine(
            server.cfg.selection, server.cfg.comm,
            robust_agg=server.cfg.robust_agg)
        self.weights = np.asarray(
            [cs.num_samples for cs in server.clients], float)
        self.stacked = round_engine.stack_pytrees(
            [cs.params for cs in server.clients])
        self._scan_static = None

    def run_round(self, t: int, rk: np.ndarray, losses: np.ndarray,
                  d_used: np.ndarray) -> _RoundData:
        srv, cfg = self.srv, self.srv.cfg
        obs = srv.obs
        n = srv.tel.num_clients
        dense = cfg.scheme != "feddd"
        part = (np.ones(n, bool) if not dense
                else srv._participants(losses))
        with obs.span("local_train", round=t):
            if self.batched_train_fn is not None:
                stacked_new, loss_dev = self.batched_train_fn(self.stacked,
                                                              rk)
                loss_dev = torch.as_tensor(loss_dev, dtype=torch.float32)
                if dense:
                    pvec = torch.as_tensor(part, device=srv.device)
                    stacked_new = round_engine.keep_participants(
                        pvec, stacked_new, self.stacked)
                    loss_dev = torch.where(pvec, loss_dev, torch.as_tensor(
                        losses, dtype=torch.float32, device=srv.device))
            else:
                new_list, loss_dev = [], []
                for i, p_i in enumerate(round_engine.unstack_pytree(
                        self.stacked, n)):
                    if part[i]:
                        p, l = self.local_train_fn(p_i, i,
                                                   prng.fold_in(rk, i))
                    else:       # baseline non-participant: stale state
                        p, l = p_i, losses[i]
                    new_list.append(p)
                    loss_dev.append(l)
                stacked_new = round_engine.stack_pytrees(new_list)
        with obs.span("engine_step", round=t):
            out = self.engine.step(self.stacked, stacked_new,
                                   srv.global_params, d_used,
                                   self.weights * part, rk,
                                   full_round=(t % cfg.h == 0) or dense,
                                   dense_masks=dense)
        srv.global_params = out.global_params
        self.stacked = out.client_params
        # the round's one device-to-host copy (a fused trainer's losses
        # ride in it)
        with obs.span("host_transfer", round=t):
            if isinstance(loss_dev, torch.Tensor):
                dens, oh, new_losses = obs.to_host(
                    _to_host, out.densities, out.wire_overhead, loss_dev)
            else:
                dens, oh = obs.to_host(_to_host, out.densities,
                                       out.wire_overhead)
                new_losses = [float(l) for l in loss_dev]
        new_losses = np.asarray(new_losses, float)
        uploaded, wire = account_uplink(dens, part, srv.tel.model_bytes, oh,
                                        cfg.comm, obs=obs)
        return _RoundData(new_losses, uploaded, part, None, wire)

    def run_chunk(self, t_start: int, count: int,
                  losses: np.ndarray) -> round_engine.ScanTrace:
        """Rounds ``t_start .. t_start + count - 1`` in one
        ``BatchedRoundEngine.run`` call; rebinds the stacked client
        state, the global params and the key from its carry and returns
        the host copy of its :class:`ScanTrace` (the chunk's one
        transfer).  Before the first chunk the executor copies the global
        params, so its carry never aliases the caller's tensors."""
        srv, cfg = self.srv, self.srv.cfg
        dev = srv.device
        if self._scan_static is None:
            srv.global_params = tree.tree_map(torch.clone, srv.global_params)
            static_part, pen, budget = None, None, 0.0
            if cfg.scheme == "fedcs":
                static_part = torch.as_tensor(baselines.select_fedcs(
                    srv.tel, a_server=cfg.a_server), device=dev)
            elif cfg.scheme == "oort":
                pen = allocation.stage(baselines.oort_system_penalty(srv.tel),
                                       dev)
                budget = cfg.a_server * float(np.sum(srv.tel.model_bytes))
            self._scan_static = (
                round_engine.ScanTelemetry.from_host(srv.tel, dev),
                allocation.stage(self.weights, dev), static_part, pen,
                budget)
        scan_tel, weights, static_part, pen, budget = self._scan_static
        state = round_engine.ScanState(
            client_params=self.stacked, global_params=srv.global_params,
            losses=allocation.stage(losses, dev),
            dropout=allocation.stage(srv.dropout, dev), rng=srv.rng,
            sim_time=torch.zeros((), dtype=torch.float32, device=dev))
        out, trace = self.engine.run(
            state, scan_tel, num_rounds=count,
            batched_train_fn=self.batched_train_fn, weights=weights,
            h=cfg.h, a_server=cfg.a_server, d_max=cfg.d_max,
            delta=cfg.delta,
            global_model_bytes=_tree_bytes(srv.global_params),
            t_start=t_start, scheme=cfg.scheme,
            static_participants=static_part, oort_penalty=pen,
            oort_budget=budget)
        self.stacked = out.client_params
        srv.global_params = out.global_params
        srv.rng = out.rng
        with srv.obs.span("host_transfer", round=t_start):
            return srv.obs.to_host(trace.to_host)

    def finalize(self) -> None:
        for cs, p in zip(self.srv.clients, round_engine.unstack_pytree(
                self.stacked, self.srv.tel.num_clients)):
            cs.params = p

    def snapshot_arrays(self):
        return {"stacked": self.stacked}

    def restore_arrays(self, arrays) -> None:
        self.stacked = convert.to_torch(arrays["stacked"], self.srv.device)


class _ShardedEngineExecutor(_EngineExecutor):
    """Homogeneous fleets over a client mesh: one ShardedRoundEngine step
    a round, with the engine executor's flow (it inherits ``run_round``).
    Each shard runs its rows' masks, partials and Eq. (5); the Eq. (4)
    reduction is the one exchange between shards, and its bytes are
    counted once a round (``account_collective``, host arithmetic only).
    The stacked state stays on the server's device between rounds; a
    shard on another card gets its rows by non-blocking copies."""

    def __init__(self, server: "FedDDServer", local_train_fn,
                 batched_train_fn=None):
        super().__init__(server, local_train_fn, batched_train_fn)
        cfg = server.cfg
        self.engine = round_engine.ShardedRoundEngine(
            cfg.selection, cfg.comm,
            mesh=resolve_client_mesh(cfg.mesh, server.device),
            collective=cfg.mesh_collective,
            keep_fraction=cfg.mesh_keep_fraction,
            robust_agg=cfg.robust_agg)
        self._spec = WireSpec.from_params(server.global_params,
                                          cfg.selection.channel_axis)

    def run_round(self, t: int, rk: np.ndarray, losses: np.ndarray,
                  d_used: np.ndarray) -> _RoundData:
        data = super().run_round(t, rk, losses, d_used)
        account_collective(
            self._spec, self.engine.num_shards,
            mode=self.srv.cfg.mesh_collective,
            k_fraction=self.srv.cfg.mesh_keep_fraction, obs=self.srv.obs)
        return data

    def snapshot_arrays(self):
        # the JAX package's sharded state would need re-sharding on
        # restore; its executor refuses, and so does this one
        return _RoundExecutor.snapshot_arrays(self)


class _GroupedEngineExecutor(_RoundExecutor):
    """Ragged fleets: one GroupedRoundEngine step a round.  Clients are
    partitioned by sub-model shape and each group stays stacked across
    rounds; a group's coverage pytree is computed once (its members share
    widths, so they share the CR slice) and the members' keys fold their
    fleet positions, so a grouped round equals the per-client loop's."""

    def __init__(self, server: "FedDDServer", local_train_fn,
                 batched_train_fn=None):
        super().__init__(server, local_train_fn, batched_train_fn)
        from repro_torch.fl.heterogeneity import group_by_shape
        cfg = server.cfg
        self.weights = np.asarray(
            [cs.num_samples for cs in server.clients], float)
        client_params = [cs.params for cs in server.clients]
        groups = group_by_shape(client_params)
        coverage = [cov_mod.coverage_pytree(client_params[g.indices[0]],
                                            server.cr,
                                            cfg.selection.channel_axis)
                    for g in groups]
        mesh = None
        if cfg.mesh is not None:
            if cfg.mesh_collective != "dense":
                raise ValueError(
                    "sparse cross-device compaction rides the homogeneous "
                    "sharded engine; ragged (grouped) fleets reduce with "
                    "the dense collective")
            mesh = resolve_client_mesh(cfg.mesh, server.device)
        self.fleet = round_engine.GroupedFleetState(
            groups, coverage, client_params, cfg.selection,
            server.tel.num_clients, cfg.comm, mesh=mesh,
            robust_agg=cfg.robust_agg)

    def run_round(self, t: int, rk: np.ndarray, losses: np.ndarray,
                  d_used: np.ndarray) -> _RoundData:
        srv, cfg = self.srv, self.srv.cfg
        obs = srv.obs
        n = srv.tel.num_clients
        dense = cfg.scheme != "feddd"
        part = (np.ones(n, bool) if not dense
                else srv._participants(losses))
        with obs.span("local_train", round=t):
            loss_list = self.fleet.train(self.local_train_fn, rk, part,
                                         losses, d_used, dense=dense)
        with obs.span("engine_step", round=t):
            weights = torch.as_tensor(self.weights * part,
                                      dtype=torch.float32, device=srv.device)
            srv.global_params, densities, wire_oh = self.fleet.step(
                srv.global_params, weights, rk,
                full_round=(t % cfg.h == 0) or dense, dense=dense)
        with obs.span("host_transfer", round=t):
            dens, oh = obs.to_host(_to_host, densities, wire_oh)
        new_losses = np.asarray([float(l) for l in loss_list], float)
        uploaded, wire = account_uplink(dens, part, srv.tel.model_bytes, oh,
                                        cfg.comm, obs=obs)
        return _RoundData(new_losses, uploaded, part, None, wire)

    def finalize(self) -> None:
        for cs, p in zip(self.srv.clients, self.fleet.export()):
            cs.params = p


class _ReferenceLoopExecutor(_RoundExecutor):
    """The per-client loop — Algorithm 1 written out client by client.

    The oracle the engine is held to, and the only path that builds the
    per-client mask pytrees ``track_epsilon`` needs.  Each client scores
    its leaves through the importance kernel at N = 1, Eq. (4) stacks the
    uploads for the ``sparse_agg`` kernel, and each client's Eq. (5) is one
    ``masked_merge`` launch for all its leaves.  Keys: client ``i`` trains
    under ``fold_in(rk, i)``, builds masks under ``fold_in(rk, 10_000 +
    i)`` and quantizes under ``client_quant_key(rk, i)``, as the engine.
    On a ragged fleet (``server.heterogeneous``) each client's scores
    divide by its coverage slice (Eq. (21)), its upload and its mask
    (broadcast to its values) are zero-padded to global widths for
    Eq. (4), and Eq. (5)/(6) run against the global sliced to its widths.
    """

    def snapshot_arrays(self):
        return {"clients": [cs.params for cs in self.srv.clients]}

    def restore_arrays(self, arrays) -> None:
        for cs, p in zip(self.srv.clients, arrays["clients"]):
            cs.params = convert.to_torch(p, self.srv.device)

    def run_round(self, t: int, rk: np.ndarray, losses: np.ndarray,
                  d_used: np.ndarray) -> _RoundData:
        srv, cfg = self.srv, self.srv.cfg
        obs = srv.obs
        n = srv.tel.num_clients
        feddd = cfg.scheme == "feddd"
        losses = losses.copy()
        part = srv._participants(losses)
        eps_val = None

        # Step 1: local training (in FedDD everyone trains)
        new_params: List = [None] * n
        with obs.span("local_train", round=t):
            for i, cs in enumerate(srv.clients):
                if feddd or part[i]:
                    p, l = self.local_train_fn(cs.params, i,
                                               prng.fold_in(rk, i))
                    new_params[i] = p
                    losses[i] = obs.to_host(float, l)

        # Steps 2-3: masks and the (simulated) upload
        densities = np.zeros(n)
        wire_oh = None if cfg.comm.is_default else np.zeros(n)
        client_masks: List = [None] * n
        with obs.span("encode", round=t):
            if feddd:
                for i, cs in enumerate(srv.clients):
                    cov = (cov_mod.coverage_pytree(
                        cs.params, srv.cr, cfg.selection.channel_axis)
                        if srv.heterogeneous else None)
                    m = selection.build_masks(
                        cs.params, new_params[i], d_used[i],
                        config=cfg.selection, coverage=cov,
                        rng=prng.fold_in(rk, selection.MASK_KEY_OFFSET + i))
                    client_masks[i] = m
                    densities[i] = obs.to_host(
                        _host_float, selection.mask_density(new_params[i], m))
            else:
                for i in np.flatnonzero(part):
                    client_masks[i] = tree.tree_map(
                        lambda w: torch.ones((1,) * w.ndim, dtype=w.dtype,
                                             device=w.device), new_params[i])
                    densities[i] = 1.0
            uploads = np.asarray([m is not None for m in client_masks])
            if wire_oh is not None:
                for i in np.flatnonzero(uploads):
                    # baseline full uploads charge the closed-form
                    # full-upload constant at true widths, as the engine
                    wire_oh[i] = (
                        wire_codecs.mask_overhead_bytes(
                            client_masks[i], new_params[i], cfg.comm)
                        if feddd else wire_codecs.full_upload_overhead_bytes(
                            srv.wire_specs[i], cfg.comm))

        # Step 4: Eq. (4) over the uploads the server decoded; the int8
        # scale is the true quotient of the JAX package's eager loop (its
        # jitted engine multiplies by the reciprocal: an ulp apart)
        idxs = np.flatnonzero(uploads)
        with obs.span("aggregate", round=t):
            agg_params = [
                new_params[i] if cfg.comm.qbits == 32 else
                wire_quant.quantize_dequantize(
                    new_params[i], wire_quant.client_quant_key(rk, i),
                    cfg.comm.qbits, exact_scale=True)
                for i in idxs]
            agg_masks = [client_masks[i] for i in idxs]
            if srv.heterogeneous:
                agg_params = [srv._pad_to_global(p) for p in agg_params]
                agg_masks = [srv._pad_mask_to_global(client_masks[i],
                                                     new_params[i])
                             for i in idxs]
            if cfg.track_epsilon:
                eps_val = obs.to_host(
                    _host_float, estimate_epsilon(agg_params, agg_masks))
            srv.global_params = aggregation.aggregate_sparse(
                agg_params, agg_masks,
                [srv.clients[i].num_samples for i in idxs],
                prev_global=srv.global_params)

        # Steps 6-7: download and the local update, Eq. (5) or Eq. (6)
        full_round = (t % cfg.h == 0) or not feddd
        with obs.span("client_update", round=t):
            for i, cs in enumerate(srv.clients):
                if full_round:     # non-participants too: the global
                    cs.params = srv._slice_like(
                        srv.global_params, new_params[i]
                        if new_params[i] is not None else cs.params)
                elif new_params[i] is not None:
                    cs.params = aggregation.client_update_sparse(
                        srv._slice_like(srv.global_params, new_params[i]),
                        new_params[i], client_masks[i])

        uploaded, wire = account_uplink(densities, uploads,
                                        srv.tel.model_bytes, wire_oh,
                                        cfg.comm, obs=obs)
        active = np.ones(n, bool) if feddd else part
        return _RoundData(losses, uploaded, active, eps_val, wire)


def _to_host(densities: torch.Tensor, wire_overhead, losses=None):
    """The engine round's one device-to-host copy: the (N,) float32
    densities, with a non-default wire format the (N,) int32 overhead
    (its bits ride in the same float32 buffer), and a fused trainer's
    (N,) float32 losses -> (densities, overhead or None[, losses])."""
    n = densities.shape[0]
    parts = [densities]
    if losses is not None:
        parts.append(losses)
    if wire_overhead is not None:
        parts.append(wire_overhead.view(torch.float32))
    host = torch.cat(parts).cpu().numpy() if len(parts) > 1 else \
        densities.cpu().numpy()
    oh = (None if wire_overhead is None
          else np.ascontiguousarray(host[-n:]).view(np.int32))
    if losses is None:
        return host[:n], oh
    return host[:n], oh, host[n:2 * n]


def _host_float(x: torch.Tensor) -> float:
    """The loop's per-client read of a 0-D device value (a sync each)."""
    return float(x)


class FedDDServer:
    """Parameter server for FedDD and the three baselines."""

    def __init__(self, global_params, cfg: ProtocolConfig,
                 telemetry: ClientTelemetry, client_params=None, *,
                 device: DeviceLike = None):
        """``client_params``: per-client starting params (numpy or
        tensors), default the global model for every client; sub-models
        pruned in width from the global (HeteroFL-style: the same
        structure, a leading [0:w) block of each axis) make the fleet
        heterogeneous and route it to the grouped engine."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tel = telemetry
        self.global_params = convert.to_torch(global_params, self.device)
        n = telemetry.num_clients
        if client_params is None:
            client_params = [self.global_params] * n
        else:
            client_params = [convert.to_torch(p, self.device)
                             for p in client_params]
        self.clients = [ClientState(p, int(m)) for p, m in
                        zip(client_params, telemetry.num_samples)]
        axis = cfg.selection.channel_axis
        full_w = cov_mod.channel_widths(self.global_params, axis)
        cw = [cov_mod.channel_widths(p, axis) for p in client_params]
        self.cr = cov_mod.coverage_rates(cw, full_w)
        self.heterogeneous = any(w != full_w for w in cw)
        # per-client wire shapes: the analytic byte model behind the
        # Eq. (12) uplink charge and the overhead-aware allocation
        self.wire_specs = [WireSpec.from_params(p, axis)
                           for p in client_params]
        self.dropout = np.zeros(telemetry.num_clients)   # D_n^1 = 0
        self.rng = prng.PRNGKey(cfg.seed)
        # the inert recorder until run() builds one for an active cfg.obs
        self.obs = obs_mod.NULL_RECORDER

    def allocate(self, losses: np.ndarray) -> AllocationResult:
        tel = dataclasses.replace(self.tel, train_loss=losses)
        return solve_dropout_rates_with(
            self.cfg.allocator, tel,
            a_server=self.cfg.a_server, d_max=self.cfg.d_max,
            delta=self.cfg.delta,
            global_model_bytes=_tree_bytes(self.global_params),
            comm=self.cfg.comm, wire_specs=self.wire_specs,
            device=self.device)

    def _participants(self, losses: np.ndarray) -> np.ndarray:
        if self.cfg.scheme == "fedavg":
            return baselines.select_fedavg(self.tel)
        if self.cfg.scheme == "fedcs":
            return baselines.select_fedcs(self.tel,
                                          a_server=self.cfg.a_server)
        if self.cfg.scheme == "oort":
            tel = dataclasses.replace(self.tel, train_loss=losses)
            return baselines.select_oort(tel, a_server=self.cfg.a_server)
        return np.ones(self.tel.num_clients, bool)   # feddd: everyone

    def _executor_kind(self, batched_train_fn=None) -> str:
        """``track_epsilon`` needs the loop's per-client masks;
        ``batched=False`` asks for the loop as the oracle; a ragged fleet
        runs the grouped engine.  A fused trainer needs the homogeneous
        engine (a ragged fleet's data and models do not stack), the
        robust Eq. (4) variants an engine."""
        if self.cfg.track_epsilon or not self.cfg.batched:
            kind = "loop"
        elif self.heterogeneous:
            kind = "grouped"
        else:
            kind = "engine"
        if self.cfg.mesh is not None:
            if kind == "loop":
                raise ValueError(
                    "mesh (client-sharded rounds) requires engine-backed "
                    "execution; track_epsilon / batched=False route to "
                    "the per-client reference loop, which does not shard")
            if kind == "engine":
                kind = "sharded"
            # grouped: the GroupedRoundEngine shards each group's member
            # axis itself (_GroupedEngineExecutor)
        if batched_train_fn is not None and kind not in ("engine",
                                                         "sharded"):
            raise ValueError(
                "batched_train_fn requires a homogeneous run with "
                "batched=True and track_epsilon=False")
        if str(self.cfg.robust_agg) != "mean" and kind == "loop":
            raise ValueError(
                "robust_agg variants are fused into the engine-backed "
                "stacked Eq. (4) step; the reference loop aggregates "
                "per-client lists with the plain weighted mean (run with "
                "batched=True and track_epsilon=False)")
        return kind

    _EXECUTORS = {"engine": _EngineExecutor,
                  "sharded": _ShardedEngineExecutor,
                  "grouped": _GroupedEngineExecutor,
                  "loop": _ReferenceLoopExecutor}

    @property
    def executor_kind(self) -> str:
        """The executor a plain ``run(local_train_fn)`` routes to:
        "engine" (homogeneous), "sharded" (homogeneous with ``mesh=``),
        "grouped" (ragged fleet, with or without a mesh) or "loop"."""
        return self._executor_kind()

    def run(self, local_train_fn: Optional[Callable] = None,
            eval_fn: Optional[Callable[[object], Dict]] = None,
            rounds: Optional[int] = None,
            batched_train_fn: Optional[Callable] = None) -> RunResult:
        """Run the protocol.

        Args:
          local_train_fn: per-client ``(params, client_idx, key) ->
            (params, loss)``; required unless ``batched_train_fn`` is
            given.
          eval_fn: ``params -> metrics dict``, once a round (not with
            ``rounds_per_dispatch > 1``).
          batched_train_fn: ``(stacked_params, key) -> (stacked_params,
            (N,) losses)`` on client-stacked pytrees (engine runs only;
            ``round_engine.make_batched_train_fn`` builds one): local
            training in one fused call, and the scanned path's trainer.
        """
        cfg = self.cfg
        rounds = rounds or cfg.rounds
        n = self.tel.num_clients
        if local_train_fn is None and batched_train_fn is None:
            raise ValueError("need local_train_fn or batched_train_fn")
        losses = np.ones(n)
        sim_time = 0.0
        history: List[RoundRecord] = []
        full_bytes = float(np.sum(self.tel.model_bytes))
        kind = self._executor_kind(batched_train_fn)
        scanned = cfg.rounds_per_dispatch > 1
        if scanned:
            if kind != "engine":
                raise ValueError(
                    "rounds_per_dispatch > 1 requires the homogeneous "
                    "batched engine (batched=True, track_epsilon=False, "
                    f"homogeneous fleet); this run routes to {kind!r}")
            if batched_train_fn is None:
                raise ValueError(
                    "rounds_per_dispatch > 1 requires batched_train_fn: "
                    "local training must be device-fused for the rounds "
                    "to run without a host round trip")
            if eval_fn is not None:
                raise ValueError(
                    "eval_fn evaluates every round on the host, but with "
                    "rounds_per_dispatch > 1 params only reach the host "
                    "at chunk boundaries; use rounds_per_dispatch=1 for "
                    "per-round eval")
        executor = self._EXECUTORS[kind](self, local_train_fn,
                                         batched_train_fn)
        # crash-resume: restore a snapshot before the loop, save one every
        # checkpoint_every completed rounds; None for both touches nothing
        start_t = 1
        if cfg.resume_from:
            from repro_torch import checkpoint as ckpt_mod
            st = ckpt_mod.load_run_state(
                cfg.resume_from, self._snapshot_arrays(executor, losses))
            losses = self._restore_arrays(executor, st.arrays)
            history = st.history
            sim_time = float(st.extra.get("sim_time", 0.0))
            start_t = st.round + 1
        self.obs = obs_mod.make_recorder(
            cfg.obs, driver="protocol", device=self.device,
            scheme=cfg.scheme, executor="scanned" if scanned else kind,
            clients=n, rounds=rounds)
        try:
            if scanned:
                self._run_scanned(executor, rounds, history, full_bytes)
                executor.finalize()
                return RunResult(history, self.global_params)
            for t in range(start_t, rounds + 1):
                t0 = time.perf_counter()
                self.rng, rk = prng.split(self.rng)
                d_used = self.dropout.copy()  # D_t: what uploads use
                rd = executor.run_round(t, rk, losses, d_used)
                losses = rd.losses
                # --- Step 5: dropout-rate allocation for round t+1
                if cfg.scheme == "feddd":
                    with self.obs.span("allocate", round=t):
                        alloc = self.allocate(np.maximum(losses, 1e-6))
                    self.dropout = alloc.dropout_rates
                sim_time, round_t, metrics, t_all = self._finish_round(
                    rd.active, sim_time, eval_fn, d_used)
                history.append(RoundRecord(
                    round=t, sim_time=sim_time, sim_round_time=round_t,
                    host_wall_time=time.perf_counter() - t0,
                    mean_loss=float(np.mean(losses)),
                    dropout_rates=self.dropout.copy(),
                    uploaded_fraction=rd.uploaded_bytes / max(full_bytes,
                                                              1e-9),
                    uploaded_bytes=rd.uploaded_bytes,
                    wire_bytes=rd.wire_bytes,
                    participants=int(np.sum(rd.active)),
                    survivors=int(np.sum(rd.active)), epsilon=rd.epsilon,
                    metrics=metrics))
                if self.obs.active:
                    self.obs.round(
                        history[-1], path=kind, scheme=cfg.scheme,
                        client_times=np.where(rd.active, t_all, np.nan))
                if (cfg.checkpoint_every is not None
                        and t % cfg.checkpoint_every == 0):
                    from repro_torch import checkpoint as ckpt_mod
                    ckpt_mod.save_run_state(
                        cfg.checkpoint_path, ckpt_mod.RunState(
                            round=t,
                            arrays=self._snapshot_arrays(executor, losses),
                            history=history, extra={"sim_time": sim_time}))
            executor.finalize()
            return RunResult(history, self.global_params)
        finally:
            self.obs.close()
            self.obs = obs_mod.NULL_RECORDER

    # -- crash-resume snapshot plumbing (repro_torch.checkpoint) ------------

    def _snapshot_arrays(self, executor: _RoundExecutor,
                         losses: np.ndarray) -> Dict:
        """Everything round t+1 reads, as one checkpointable pytree: the
        executor's client state, the global params, the protocol key
        (uint32, exact), the loss view and the allocated D_{t+1}."""
        return {"executor": executor.snapshot_arrays(),
                "global": self.global_params,
                "rng": np.asarray(self.rng),
                "losses": np.asarray(losses, np.float64),
                "dropout": np.asarray(self.dropout, np.float64)}

    def _restore_arrays(self, executor: _RoundExecutor,
                        arrays: Dict) -> np.ndarray:
        """Inverse of :meth:`_snapshot_arrays`; returns the loss view."""
        executor.restore_arrays(arrays["executor"])
        self.global_params = convert.to_torch(arrays["global"], self.device)
        self.rng = np.asarray(arrays["rng"], np.uint32)
        self.dropout = np.asarray(arrays["dropout"], np.float64)
        return np.asarray(arrays["losses"], np.float64)

    def _run_scanned(self, executor: _EngineExecutor, rounds: int,
                     history: List[RoundRecord], full_bytes: float) -> None:
        """``rounds_per_dispatch`` rounds per ``BatchedRoundEngine.run``
        call, spliced back into the per-round :class:`RoundRecord` stream.

        The records replay on the host, in float64, what the per-round
        driver computes: the clip of the traced rates and the Eq. (12)
        clock from them and the participation, so a scanned history
        equals the per-round one bit for bit.  ``host_wall_time`` is the
        chunk's wall time over its rounds."""
        cfg = self.cfg
        losses = np.ones(self.tel.num_clients)
        sim_time = 0.0
        t = 1
        while t <= rounds:
            k = min(cfg.rounds_per_dispatch, rounds - t + 1)
            t0 = time.perf_counter()
            with self.obs.span("chunk_dispatch", round=t):
                trace = executor.run_chunk(t, k, losses)
            wall = (time.perf_counter() - t0) / k
            for j in range(k):
                d_used = self.dropout.copy()
                part = trace.participants[j]
                losses = trace.losses[j].astype(float)
                if cfg.scheme == "feddd":
                    self.dropout = np.clip(
                        trace.next_dropout[j].astype(np.float64), 0.0,
                        cfg.d_max)
                uploaded, wire = account_uplink(
                    trace.densities[j], part,
                    self.tel.model_bytes,
                    None if trace.wire_overhead is None
                    else trace.wire_overhead[j], cfg.comm, obs=self.obs)
                sim_time, round_t, _, t_all = self._finish_round(
                    part, sim_time, None, d_used)
                history.append(RoundRecord(
                    round=t + j, sim_time=sim_time, sim_round_time=round_t,
                    host_wall_time=wall, mean_loss=float(np.mean(losses)),
                    dropout_rates=self.dropout.copy(),
                    uploaded_fraction=uploaded / max(full_bytes, 1e-9),
                    uploaded_bytes=uploaded, wire_bytes=wire,
                    participants=int(np.sum(part)),
                    survivors=int(np.sum(part))))
                if self.obs.active:
                    self.obs.round(
                        history[-1], path="scanned", scheme=cfg.scheme,
                        client_times=np.where(part, t_all, np.nan))
            t += k

    def _finish_round(self, active: np.ndarray, sim_time: float, eval_fn,
                      d_used: np.ndarray):
        """The paper's Eq. (12) clock at the rates the round's uploads used
        (D_t), then the eval -> (sim_time, round time, metrics, the
        per-client times the max ran over)."""
        d_for_time = (d_used if self.cfg.scheme == "feddd"
                      else np.zeros(self.tel.num_clients))
        up = (None if self.cfg.comm.is_default else
              analytic_uplink_vector(self.wire_specs, d_for_time,
                                     self.cfg.comm))
        t_all = baselines.round_times(self.tel, d_for_time, uplink_bytes=up)
        round_t = float(np.max(t_all[active]))
        metrics = None
        if eval_fn:
            with self.obs.span("eval"):
                metrics = eval_fn(self.global_params)
        return sim_time + round_t, round_t, metrics, t_all

    # -- ragged fleets (HeteroFL-style width slicing) -----------------------

    def _pad_to_global(self, params):
        """A client's sub-model zero-padded up to global widths."""
        return tree.tree_map(lambda p, g: aggregation.pad_to(p, g.shape),
                             params, self.global_params)

    def _pad_mask_to_global(self, masks, params):
        """A client's channel-shaped masks broadcast to its values and
        zero-padded to global widths: absent positions never add to
        Eq. (4)."""
        return tree.tree_map(
            lambda m, p, g: aggregation.pad_to(m.expand(p.shape), g.shape),
            masks, params, self.global_params)

    @staticmethod
    def _slice_like(global_params, local_params):
        """A full-width pytree cut to a client's widths (contiguous)."""
        return round_engine.slice_pytree(global_params, local_params)


def run_scheme(scheme: str, global_params, telemetry, local_train_fn,
               eval_fn=None, client_params=None, *,
               device: DeviceLike = None, sim=None, network=None,
               faults=None, population=None, cohort_size=None,
               **cfg_kw) -> RunResult:
    """One-call wrapper: build the server for ``scheme`` and run it.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` for a CPU run.  ``batched=False`` or
    ``track_epsilon=True`` runs the per-client reference loop,
    ``robust_agg`` picks the Eq. (4) variant, ``obs=ObsConfig(...)``
    records spans, metrics and a JSONL log, and ``checkpoint_every`` /
    ``checkpoint_path`` / ``resume_from`` drive crash-resume.  Ragged
    ``client_params`` run the grouped engine (the loop with
    ``batched=False``).  The fused and scanned paths take a
    ``batched_train_fn``: call ``FedDDServer.run`` for them.

    ``sim`` (a :class:`repro_torch.sim.runner.SimConfig`, or ``True`` for
    the defaults), ``network``, ``faults`` or ``population`` (with
    ``cohort_size``) route the run through the event-driven simulator
    (:func:`repro_torch.sim.runner.run_sim`): per-epoch network
    conditions, observed-telemetry LP re-solves, sync / deadline / retry /
    async policies, crashes, lossy uplinks, corrupted payloads with the
    quarantine and quorum, and population serving.
    """
    if cohort_size is not None and population is None:
        raise ValueError("cohort_size requires population=")
    if (sim is not None or network is not None or faults is not None
            or population is not None):
        from repro_torch.sim import runner as sim_runner
        if sim is None or sim is True:
            sim = sim_runner.SimConfig()
        return sim_runner.run_sim(scheme, global_params, telemetry,
                                  local_train_fn, eval_fn, sim=sim,
                                  network=network, faults=faults,
                                  client_params=client_params,
                                  population=population,
                                  cohort_size=cohort_size, device=device,
                                  **cfg_kw)
    cfg = ProtocolConfig(scheme=scheme, **cfg_kw)
    server = FedDDServer(global_params, cfg, telemetry, client_params,
                         device=device)
    return server.run(local_train_fn, eval_fn)
