"""Event-driven FL runner — composes the clock engine, network models,
and aggregation policies with the batched FedDD round engine.

This is the simulator's driver, the counterpart of
:class:`repro_torch.core.protocol.FedDDServer` for *dynamic* system
conditions.  Differences from the closed-form protocol driver:

* **Time is an event queue** (sim/engine.py), not one ``max`` per round:
  every client download / compute / upload is a timestamped event, so
  deadlines can cut stragglers mid-flight and async merges can interleave.
* **Conditions change** (sim/network.py): each communication epoch draws
  true uplink/downlink/compute values from the network model (static,
  Markov fading, or trace-driven).
* **The server is not an oracle**: it re-solves the dropout-rate LP
  (core/allocation.py) every round from telemetry it *observed* on the
  event timeline — per-phase measurements carried on the download /
  compute / upload events, EWMA-smoothed — so FedDD's differential
  dropout adapts as links fade.  Ground-truth conditions never reach the
  allocation.
* **Aggregation discipline is pluggable** (sim/policies.py): synchronous
  wait-for-all, deadline semi-sync that abandons late uploads (or, with
  ``partial=True``, aggregates their delivered prefix), retry with a
  timeout, or buffered fully-async with staleness-decayed weights.

The device math is the round engines of ``core/round_engine.py`` and
their three kernels: homogeneous fleets run the
:class:`BatchedRoundEngine` step (importance, sparse_agg's mean mode,
masked_merge), ragged-width fleets the shape-grouped
:class:`GroupedRoundEngine` step.  Exclusion (deadline drops, crashes,
quarantines, baseline non-participation) and staleness decay enter as
per-client weights on the stacked Eq. (4) aggregation either way, so the
same step serves every policy and every fleet shape.  Corrupted uploads
the validation screen misses reach Eq. (4) through the step's
``stacked_upload``; deadline-cut uploads through ``delivered``.

Host traffic per round: the densities, wire overhead and losses once a
round (as the protocol's engine executor); with a fault model, one more
transfer a round for the screen's (N,) norms and finite flags.  Host
vectors the step reads (weights, delivered counts) are staged copies.

Determinism contract (tests/test_torch_sim.py): a run is a pure function
of (seed, config, network model, fleet) — same seed gives the identical
event trace, sim times, and final parameters in any process.  With the
synchronous policy over a static network this runner reproduces the
protocol driver's Eq. (12) round times and global parameters bit for
bit, for homogeneous and ragged fleets alike.

Client-sharded fleets (``ProtocolConfig.mesh``): the homogeneous wave
and async fleets step a ``ShardedRoundEngine`` over the client mesh and
the ragged ones a ``GroupedRoundEngine(mesh=)``, the protocol's routing;
the cross-shard Eq. (4) bytes are counted once a wave round
(``account_collective``).  Corruption faults, deadline partial
aggregation, a population whose cohort changes and the sparse collective
on a ragged fleet raise with a mesh, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import convert, prng, tree
from repro_torch import obs as obs_mod
from repro_torch.comm.payload import (WireSpec, account_collective,
                                      account_uplink,
                                      analytic_uplink_vector,
                                      delivered_prefix_counts)
from repro_torch.core import baselines, coverage as cov_mod, round_engine
from repro_torch.core.allocation import (ClientTelemetry,
                                         solve_dropout_rates_overhead_aware,
                                         solve_dropout_rates_with)
from repro_torch.core.protocol import (ProtocolConfig, RoundRecord,
                                       RunResult, _to_host, _tree_bytes)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import resolve_client_mesh
from repro_torch.sim import engine as ev_mod
from repro_torch.sim import faults as faults_mod
from repro_torch.sim.engine import (COMPUTE_DONE, DOWNLOAD_DONE, UPLOAD_DONE,
                                    Simulator)
from repro_torch.sim.faults import FaultModel
from repro_torch.sim.network import (NetworkModel, StaticNetwork,
                                     telemetry_with_conditions)
from repro_torch.sim.policies import AsyncPolicy, DeadlinePolicy, make_policy

# Async-path fault marker (sim/faults.py): the instant a dispatched
# client's crash or abort becomes known to the server, so the slot
# re-enters the free-running pipeline at that simulated time.
CLIENT_DOWN = "client_down"


def stage(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host vector as a tensor on ``device``: on the card through pinned
    memory and a non-blocking copy (a pageable copy would wait for the
    stream)."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@dataclasses.dataclass
class SimConfig:
    """Simulator-only knobs (protocol knobs stay on ProtocolConfig)."""

    policy: Union[str, object] = "sync"   # sync | deadline | retry | async,
                                          # or an instance from policies.py
    policy_kw: Dict = dataclasses.field(default_factory=dict)
    observation_ewma: float = 0.5         # weight on the newest measurement
    eval_every: int = 1                   # eval_fn cadence (rounds/merges)

    def resolve_policy(self):
        if isinstance(self.policy, str):
            return make_policy(self.policy, **self.policy_kw)
        return self.policy


@dataclasses.dataclass
class SimResult(RunResult):
    """RunResult + the determinism witnesses of the event timeline."""

    event_trace: List[Tuple[float, str, int]] = dataclasses.field(
        default_factory=list)
    observed_telemetry: Optional[ClientTelemetry] = None


class ObservedTelemetry:
    """The server's running estimate of client link/compute conditions.

    Initialised from the prior the operator supplied (the Table-4 sample
    the closed-form driver treats as an oracle) and EWMA-updated from
    measurements carried on processed events.  A measurement equal to the
    current estimate leaves it bit-identical (no ``a*x + (1-a)*x``
    round-off drift) — that is what makes the static-network sync run
    reproduce the protocol driver exactly.

    Estimates are stored per GLOBAL client id.  ``ids`` (population mode,
    repro_torch.population) maps the current cohort's stack positions to
    global ids: events carry stack positions, so measurements land on the
    global row, and :meth:`telemetry` gathers the cohort's rows back out.
    With ``ids=None`` (fleet == population) positions and ids coincide.
    """

    def __init__(self, prior: ClientTelemetry, ewma: float,
                 ids: Optional[np.ndarray] = None):
        if not 0.0 < ewma <= 1.0:
            raise ValueError(f"observation_ewma must be in (0,1], {ewma}")
        self.base = prior
        self.ewma = ewma
        self.ids = None if ids is None else np.asarray(ids, np.int64)
        self.uplink = np.asarray(prior.uplink_rate, float).copy()
        self.downlink = np.asarray(prior.downlink_rate, float).copy()
        self.compute = np.asarray(prior.compute_latency, float).copy()

    def retarget(self, ids: np.ndarray) -> None:
        """Point the stack-position -> global-id map at a new cohort."""
        self.ids = np.asarray(ids, np.int64)

    def _update(self, arr: np.ndarray, i: int, measured: float) -> None:
        # estimates update ONLY from measurements that actually landed; a
        # client whose upload never arrived (crash, abort, deadline cut)
        # produces no event and its estimate stays stale rather than
        # zero-filled.  Non-finite measurements are discarded outright.
        if np.isfinite(measured) and measured != arr[i]:
            arr[i] = self.ewma * measured + (1.0 - self.ewma) * arr[i]

    def observe(self, event: ev_mod.Event) -> None:
        """Fold one event's measurement payload into the estimates."""
        if event.payload is None or event.client < 0:
            return
        kind, value = event.payload
        i = (event.client if self.ids is None
             else int(self.ids[event.client]))
        if kind == "uplink":
            self._update(self.uplink, i, value)
        elif kind == "downlink":
            self._update(self.downlink, i, value)
        elif kind == "compute":
            self._update(self.compute, i, value)

    def telemetry(self, train_loss: np.ndarray) -> ClientTelemetry:
        """Estimates as a ClientTelemetry for the allocation LP /
        selection baselines — gathered at the cohort's global ids when a
        map is bound (``train_loss`` is cohort-shaped either way)."""
        if self.ids is None:
            return dataclasses.replace(
                self.base, uplink_rate=self.uplink.copy(),
                downlink_rate=self.downlink.copy(),
                compute_latency=self.compute.copy(),
                train_loss=np.asarray(train_loss, float))
        idx = self.ids
        return dataclasses.replace(
            self.base.subset(idx), uplink_rate=self.uplink[idx],
            downlink_rate=self.downlink[idx],
            compute_latency=self.compute[idx],
            train_loss=np.asarray(train_loss, float))


class _StackedWaveFleet:
    """Homogeneous wave-policy device state: ONE client-stacked pytree that
    persists across rounds and one BatchedRoundEngine step per round."""

    def __init__(self, runner: "SimRunner"):
        self.runner = runner
        self.engine = runner.engine
        self.stacked = round_engine.stack_pytrees(runner.client_params)
        self._new = None

    def train(self, local_train_fn, rk, part, losses, d_used) -> List:
        del d_used      # homogeneous stacks defer dropout to step()
        n = self.runner.tel.num_clients
        per_client = round_engine.unstack_pytree(self.stacked, n)
        new_list, loss_out = [None] * n, [None] * n
        for i, p_i in enumerate(per_client):
            if part[i]:
                p, l = local_train_fn(p_i, i, prng.fold_in(rk, i))
            else:
                p, l = p_i, losses[i]
            new_list[i], loss_out[i] = p, l
        self._new = round_engine.stack_pytrees(new_list)
        return loss_out

    def step(self, d_used, weights, rk, *, full_round, dense,
             delivered=None, overrides=None):
        r = self.runner
        upload = None
        if overrides:
            # wire-side corruption the validation screen missed: the
            # AGGREGATION reads the corrupted rows, the client's own
            # Eq. (5) state stays its clean ``_new``
            upload = tree.tree_map(torch.clone, self._new)
            ul = tree.leaves(upload)
            for i, row in sorted(overrides.items()):
                for leaf, c in zip(ul, tree.leaves(row)):
                    leaf[i] = torch.from_numpy(np.asarray(c)).to(
                        device=leaf.device, dtype=leaf.dtype)
        out = self.engine.step(self.stacked, self._new, r.global_params,
                               d_used, weights, rk, full_round=full_round,
                               dense_masks=dense, stacked_upload=upload,
                               delivered=delivered)
        r.global_params = out.global_params
        self.stacked = out.client_params
        return out.densities, out.wire_overhead

    def discard(self) -> None:
        """Drop the staged round (quorum miss): params stay put."""
        self._new = None

    def upload_stats(self):
        """(norms, finite) of the staged updates, fleet order: one device
        reduction, one transfer."""
        return faults_mod.update_stats_stacked(self._new, self.stacked)

    def row_params(self, i: int):
        """Client ``i``'s (old, new) rows of the staged update (views; the
        corruption works on a host copy)."""
        old = tree.tree_map(lambda l: l[i], self.stacked)
        new = tree.tree_map(lambda l: l[i], self._new)
        return old, new

    def export(self) -> List:
        n = self.runner.tel.num_clients
        return round_engine.unstack_pytree(self.stacked, n)


class _GroupedWaveFleet:
    """Ragged wave-policy device state: a thin adapter over the shared
    :class:`repro_torch.core.round_engine.GroupedFleetState` (the SAME
    implementation the protocol's grouped executor drives).  Exclusion
    weights stay a full (N,) fleet vector; each group's rows index into
    it by the members' fleet positions."""

    def __init__(self, runner: "SimRunner"):
        self.runner = runner
        self.state = round_engine.GroupedFleetState(
            runner.groups, runner.group_coverage, runner.client_params,
            runner.cfg.selection, runner.tel.num_clients, runner.cfg.comm,
            mesh=runner.mesh, robust_agg=runner.cfg.robust_agg)

    def train(self, local_train_fn, rk, part, losses, d_used) -> List:
        return self.state.train(local_train_fn, rk, part, losses, d_used,
                                dense=self.runner.cfg.scheme != "feddd")

    def step(self, d_used, weights, rk, *, full_round, dense,
             delivered=None, overrides=None):
        del d_used      # already in the batches train() staged
        if delivered is not None or overrides:
            # SimRunner.__init__ rejects corruption / partial aggregation
            # for ragged fleets before a round can reach here
            raise NotImplementedError(
                "upload overrides / delivered prefixes are homogeneous-"
                "engine features")
        r = self.runner
        r.global_params, densities, wire_oh = self.state.step(
            r.global_params, weights, rk, full_round=full_round,
            dense=dense)
        return densities, wire_oh

    def discard(self) -> None:
        """Drop the staged round (quorum miss): params stay put."""
        self.state.discard()

    def upload_stats(self):
        """(norms, finite) of the staged updates, fleet order: one device
        reduction per group, one transfer for all of them."""
        n = self.runner.tel.num_clients
        dev = self.runner.device
        sq = torch.zeros((n,), dtype=torch.float32, device=dev)
        finite = torch.ones((n,), dtype=torch.bool, device=dev)
        for b, rows in zip(self.state.staged_batches, self.state.rows):
            s, f = faults_mod.update_stats_device(b.stacked_new,
                                                  b.stacked_old)
            sq.index_copy_(0, rows, s)
            finite.index_copy_(0, rows, f)
        return faults_mod.stats_to_host(sq, finite)

    def export(self) -> List:
        return self.state.export()


class SimRunner:
    """Event-driven federated run; homogeneous or ragged-width fleets."""

    def __init__(self, global_params, cfg: ProtocolConfig,
                 telemetry: ClientTelemetry, simcfg: SimConfig,
                 network: Optional[NetworkModel] = None,
                 client_params: Optional[List] = None,
                 faults: Optional[FaultModel] = None,
                 population=None, cohort_size: Optional[int] = None, *,
                 device: DeviceLike = None):
        if cfg.track_epsilon:
            raise ValueError("track_epsilon is a per-client-loop feature; "
                             "the sim runner does not support it")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.simcfg = simcfg
        self.policy = simcfg.resolve_policy()
        self.network = network or StaticNetwork(telemetry)
        if self.network.num_clients != telemetry.num_clients:
            raise ValueError("network model / telemetry client count "
                             "mismatch")
        self.global_params = convert.to_torch(global_params, self.device)
        # population-scale serving (repro_torch.population): ``telemetry``
        # (and the network model) cover the POPULATION; only the sampled
        # cohort is materialized into engine buffers.  With always-on
        # availability and cohort == population the gathered arrays equal
        # the fleet's own, which is the bit-identity contract.
        self.population = population
        self.pop_tel = None
        self.cohort = None
        if population is not None:
            if population.size != telemetry.num_clients:
                raise ValueError(
                    f"population size {population.size} / telemetry "
                    f"count {telemetry.num_clients} mismatch")
            k = population.size if cohort_size is None else int(cohort_size)
            if not 1 <= k <= population.size:
                raise ValueError(f"cohort_size {k} outside "
                                 f"[1, {population.size}]")
            if isinstance(self.policy, AsyncPolicy):
                raise ValueError(
                    "population cohorts rebind the wave fleet between "
                    "rounds; the async merge stream has no such boundary "
                    "— run populations under sync/deadline/retry")
            if cfg.checkpoint_every is not None or cfg.resume_from:
                raise ValueError(
                    "population sticky state does not ride the RunState "
                    "snapshot; run checkpoint/resume without population=")
            if cfg.mesh is not None and not population.sampler.static:
                raise ValueError(
                    "client-sharded (mesh) fleets keep their shard layout "
                    "for the whole run; population runs on a mesh need a "
                    "static cohort (identity sampler, or cohort_size == "
                    "population with always-on availability)")
            if client_params is not None:
                population.seed_params(
                    [convert.to_torch(p, self.device)
                     for p in client_params])
            self.pop_tel = telemetry
            self.cohort = np.asarray(population.sample_cohort(0, k),
                                     np.int64)
            telemetry = telemetry.subset(self.cohort)
            client_params = population.cohort_params(self.cohort,
                                                     self.global_params)
        self.tel = telemetry
        n = telemetry.num_clients
        if client_params is None:
            client_params = [self.global_params] * n
        elif len(client_params) != n:
            raise ValueError("client_params / telemetry count mismatch")
        self.client_params = [convert.to_torch(p, self.device)
                              for p in client_params]
        self._partition_fleet()
        # client-sharded fleets (cfg.mesh): the protocol's routing, the
        # sharded engine for a homogeneous fleet and the sharded grouped
        # step for a ragged one
        self.mesh = None
        if cfg.mesh is not None:
            self.mesh = resolve_client_mesh(cfg.mesh, self.device)
            if faults is not None and faults.may_corrupt:
                raise ValueError(
                    "payload corruption rewrites single rows of the "
                    "stacked upload on the host; client-sharded (mesh) "
                    "fleets keep rows on their shard — run corruption "
                    "faults without a mesh")
            if isinstance(self.policy, DeadlinePolicy) and \
                    self.policy.partial:
                raise ValueError(
                    "partial aggregation of delivered prefixes is a "
                    "single-device engine feature; run deadline "
                    "partial=True without a mesh")
        if self.mesh is not None and not self.heterogeneous:
            self.engine = round_engine.ShardedRoundEngine(
                cfg.selection, cfg.comm, mesh=self.mesh,
                collective=cfg.mesh_collective,
                keep_fraction=cfg.mesh_keep_fraction,
                robust_agg=cfg.robust_agg)
        else:
            if self.mesh is not None and cfg.mesh_collective != "dense":
                raise ValueError(
                    "sparse cross-device compaction rides the homogeneous "
                    "sharded engine; ragged (grouped) fleets reduce with "
                    "the dense collective")
            self.engine = round_engine.BatchedRoundEngine(
                cfg.selection, cfg.comm, robust_agg=cfg.robust_agg)
        # async ragged merges only; ragged + mesh + non-mean robust_agg
        # raises in GroupedRoundEngine itself
        self.grouped_engine = round_engine.GroupedRoundEngine(
            cfg.selection, cfg.comm, self.mesh,
            cfg.robust_agg if self.heterogeneous else "mean")
        # the cross-shard collective's byte model under cfg.mesh
        self._global_spec = WireSpec.from_params(
            self.global_params, cfg.selection.channel_axis)
        self.faults = faults
        if faults is not None and isinstance(self.policy, AsyncPolicy) \
                and faults.may_corrupt:
            raise ValueError(
                "payload corruption is wave-policy only (sync/deadline/"
                "retry): the async merge consumes pending client pytrees, "
                "not a staged stacked upload the runner can override; "
                "async fault runs support crash / loss / retry and the "
                "staleness-budget quorum")
        if isinstance(self.policy, AsyncPolicy) and (
                cfg.checkpoint_every is not None or cfg.resume_from):
            raise ValueError(
                "checkpoint/resume snapshots at wave-round boundaries; "
                "the async merge stream keeps in-flight pending state "
                "with no such boundary — run checkpointing under the "
                "sync/deadline/retry policies")
        if self.heterogeneous:
            if faults is not None and faults.may_corrupt:
                raise ValueError(
                    "payload corruption rides the homogeneous stacked "
                    "engine's upload overrides; ragged fleets support "
                    "crash / loss / quorum faults only")
            if isinstance(self.policy, DeadlinePolicy) and \
                    self.policy.partial:
                raise ValueError(
                    "partial aggregation of delivered prefixes requires "
                    "the homogeneous stacked engine")
        # EWMAs live per GLOBAL id: population mode sizes them to the
        # population and binds the cohort's position -> id map
        self.observed = (
            ObservedTelemetry(self.pop_tel, simcfg.observation_ewma,
                              ids=self.cohort)
            if population is not None else
            ObservedTelemetry(telemetry, simcfg.observation_ewma))
        self.dropout = (population.cohort_dropout(self.cohort)
                        if population is not None
                        else np.zeros(n))     # D_n^1 = 0 (Algorithm 1)
        self.rng = prng.PRNGKey(cfg.seed)
        self.sim = Simulator()
        # observability hook (repro_torch.obs): inert until a run entry
        # point builds a live recorder for an active cfg.obs
        self.obs = obs_mod.NULL_RECORDER

    # -- fleet binding (shared by __init__ and cohort retargeting) -----------

    def _partition_fleet(self) -> None:
        """Everything derived from the CURRENT fleet's telemetry and
        params: shape groups + coverage (ragged fleets), wire specs,
        Eq. (4) weights.  Called once at __init__ for plain runs and on
        every cohort change in population mode."""
        from repro_torch.fl.heterogeneity import group_by_shape
        cfg = self.cfg
        n = self.tel.num_clients
        axis = cfg.selection.channel_axis
        full_w = cov_mod.channel_widths(self.global_params, axis)
        cw = [cov_mod.channel_widths(p, axis) for p in self.client_params]
        self.heterogeneous = any(w != full_w for w in cw)
        self.cr = cov_mod.coverage_rates(cw, full_w)
        self.groups = group_by_shape(self.client_params)
        self.group_coverage = [
            cov_mod.coverage_pytree(self.client_params[g.indices[0]],
                                    self.cr, axis)
            for g in self.groups
        ]
        # fleet-position -> coverage pytree (async merges look coverage up
        # by the arriving client's index)
        self._client_coverage = [None] * n
        for g, cov in zip(self.groups, self.group_coverage):
            for i in g.indices:
                self._client_coverage[i] = cov
        # per-client wire specs: the codec byte model the event timeline
        # charges on the uplink leg (repro_torch.comm)
        self.wire_specs = [WireSpec.from_params(p, axis)
                           for p in self.client_params]
        self.weights = np.asarray(self.tel.num_samples, float)
        self.full_bytes = float(np.sum(self.tel.model_bytes))

    def _make_fleet(self):
        return (_GroupedWaveFleet(self) if self.heterogeneous
                else _StackedWaveFleet(self))

    def _conditions(self, epoch: int):
        """This epoch's true network conditions, cohort-shaped: in
        population mode the model covers the population, so the cohort's
        rows are gathered out (value-identical when cohort == arange)."""
        cond = self.network.conditions(epoch)
        if self.population is None:
            return cond
        ids = self.cohort
        return type(cond)(*[np.asarray(a, float)[ids] for a in cond])

    def _bind_cohort(self, ids: np.ndarray) -> None:
        """Rebind every cohort-shaped view to a new member list."""
        pop = self.population
        self.cohort = np.asarray(ids, np.int64)
        self.tel = self.pop_tel.subset(self.cohort)
        self.client_params = pop.cohort_params(self.cohort,
                                               self.global_params)
        self._partition_fleet()
        self.dropout = pop.cohort_dropout(self.cohort)
        self.observed.retarget(self.cohort)

    def _retarget_cohort(self, t: int, fleet, losses: np.ndarray):
        """Sample round ``t``'s cohort; when membership changed, park the
        outgoing cohort's learning state in the store and rebuild the
        wave fleet for the incoming one.  A static cohort never rebinds —
        the engines keep their buffers, preserving bit-identity."""
        pop = self.population
        ids = np.asarray(pop.sample_cohort(t - 1, len(self.cohort)),
                         np.int64)
        if np.array_equal(ids, self.cohort):
            return fleet, losses
        pop.fold_back(self.cohort, fleet.export(), dropout=self.dropout,
                      losses=losses)
        self._bind_cohort(ids)
        return self._make_fleet(), pop.losses_for(self.cohort)

    def _population_round_done(self, t: int, part: np.ndarray,
                               fr, wire_vec: np.ndarray,
                               losses: np.ndarray, *,
                               contributors: np.ndarray,
                               moved: np.ndarray) -> None:
        """Fold the round's observations back into the population store
        (O(cohort)) and emit the ``cohort`` run-log event.

        ``contributors`` are the clients whose update reached the
        committed Eq. (4) aggregate (all False for a quorum-skipped
        round); ``moved`` are the clients whose upload bytes actually
        travelled, committed or wasted — the client-side byte economy.
        """
        pop = self.population
        if pop is None:
            return
        ids = self.cohort
        n = len(ids)
        extra = fr.extra_bytes if fr is not None else np.zeros(n)
        failed = part & ((fr.crashed | fr.aborted) if fr is not None
                         else np.zeros(n, bool))
        if self.obs.active:
            self.obs.event(
                "cohort", round=t, population=pop.size, cohort_size=n,
                first_contact=pop.first_contact(ids),
                cohort=[int(g) for g in ids],
                participated=[int(g) for g in ids[contributors]])
        tel = self.observed.telemetry(np.maximum(losses, 1e-6))
        util = (np.asarray(tel.num_samples, float)
                * np.sqrt(np.maximum(np.asarray(tel.train_loss, float),
                                     0.0))
                * baselines.oort_system_penalty(tel))
        pop.record_round(
            t, ids, arrived=contributors, failed=failed, losses=losses,
            uplink_bytes=np.where(moved, wire_vec + extra, 0.0),
            utilities=util)

    # -- shared server-side helpers -----------------------------------------

    @property
    def _dense(self) -> bool:
        return self.cfg.scheme != "feddd"

    def _allocate(self, losses: np.ndarray,
                  alive: Optional[np.ndarray] = None) -> None:
        """Re-solve the dropout LP from OBSERVED telemetry (never the
        network model's ground truth).

        ``alive`` restricts the solve to survivor-only telemetry (quorum-
        skipped rounds, correlated outages): crashed clients keep their
        previous rate instead of polluting the budget with stale rows; a
        fully-dead fleet leaves the allocation untouched.
        """
        tel = self.observed.telemetry(np.maximum(losses, 1e-6))
        if self.population is not None:
            # cold start: never-seen cohort members can take population-
            # mean priors (Population.cold_start="mean"); the default
            # "prior" passes through untouched
            tel = self.population.lp_telemetry(tel, self.cohort)
        kw = dict(a_server=self.cfg.a_server, d_max=self.cfg.d_max,
                  delta=self.cfg.delta,
                  global_model_bytes=_tree_bytes(self.global_params))
        if alive is not None and not alive.all():
            idx = np.flatnonzero(alive)
            if idx.size == 0:
                return
            tel_s = tel.subset(idx)
            if self.cfg.comm.overhead_aware_allocation:
                alloc = solve_dropout_rates_overhead_aware(
                    tel_s, [self.wire_specs[int(i)] for i in idx],
                    comm=self.cfg.comm, **kw)
            else:
                alloc = solve_dropout_rates_with(
                    self.cfg.allocator, tel_s, device=self.device, **kw)
            d = self.dropout.copy()
            d[idx] = alloc.dropout_rates
            self.dropout = d
            return
        if self.cfg.comm.overhead_aware_allocation:
            alloc = solve_dropout_rates_overhead_aware(
                tel, self.wire_specs, comm=self.cfg.comm, **kw)
        else:
            alloc = solve_dropout_rates_with(self.cfg.allocator, tel,
                                             device=self.device, **kw)
        self.dropout = alloc.dropout_rates

    def _uplink_wire_vec(self, dropout_vec: np.ndarray
                         ) -> Optional[np.ndarray]:
        """Per-client analytic on-wire uplink bytes (None = idealized
        ``U(1-D)``, the default comm config)."""
        if self.cfg.comm.is_default:
            return None
        return analytic_uplink_vector(self.wire_specs, dropout_vec,
                                      self.cfg.comm)

    def _participants(self, losses: np.ndarray) -> np.ndarray:
        """Baseline client selection, fed the server's observed view."""
        scheme = self.cfg.scheme
        n = self.tel.num_clients
        if scheme in ("feddd", "fedavg"):
            return np.ones(n, bool)
        tel = self.observed.telemetry(losses)
        if scheme == "fedcs":
            return baselines.select_fedcs(tel, a_server=self.cfg.a_server)
        return baselines.select_oort(tel, a_server=self.cfg.a_server)

    def _schedule_round_trip(self, i: int, t0: float, d_i: float,
                             cond, total: Optional[float] = None, *,
                             extra_delay: float = 0.0,
                             cutoff: Optional[float] = None,
                             drop_upload: bool = False,
                             crash_frac: Optional[float] = None
                             ) -> Tuple[float, float, float]:
        """Queue client i's download -> compute -> upload event chain.

        ``total``, when given, pins the upload arrival to ``t0 + total``
        (the vectorised Eq. (12) row) so the sync policy's round end is
        bit-identical to the protocol driver's closed form.  The upload
        leg moves the CODEC's bytes (repro_torch.comm); the download
        broadcast stays idealized.

        Fault hooks (sim/faults.py; all no-ops by default, leaving the
        fault-free schedule bit-identical): ``extra_delay`` pushes the
        upload arrival back (retransmits + backoff), ``cutoff`` is a
        crash instant — events after it are never scheduled — and
        ``drop_upload`` suppresses the upload event entirely (crashes,
        abandoned transfers).  ``crash_frac`` is the ASYNC path's crash
        hook: the cutoff is derived from the client's own computed round
        trip and a :data:`CLIENT_DOWN` marker is queued at the crash
        instant so the free-running pipeline re-dispatches the slot.
        Returns the (download, compute, upload) completion times whether
        or not the events were scheduled.
        """
        u_eff = float(self.tel.model_bytes[i]) * (1.0 - d_i)
        r_d = float(cond.downlink_rate[i])
        r_u = float(cond.uplink_rate[i])
        t_cmp = float(cond.compute_latency[i])
        dl = t0 + u_eff / r_d
        cp = dl + t_cmp
        if total is not None:        # wave paths: arrival pinned by caller
            up = t0 + total + extra_delay
        else:                        # async path computes its own leg
            u_up = (u_eff if self.cfg.comm.is_default else
                    float(analytic_uplink_vector([self.wire_specs[i]],
                                                 np.asarray([d_i]),
                                                 self.cfg.comm)[0]))
            up = cp + u_up / r_u + extra_delay
        if crash_frac is not None:
            cutoff = t0 + float(crash_frac) * (up - t0)
            drop_upload = True
            self.sim.schedule_at(cutoff, CLIENT_DOWN, i)
        if cutoff is None or dl <= cutoff:
            self.sim.schedule_at(dl, DOWNLOAD_DONE, i, ("downlink", r_d))
        if cutoff is None or cp <= cutoff:
            self.sim.schedule_at(cp, COMPUTE_DONE, i, ("compute", t_cmp))
        if not drop_upload and (cutoff is None or up <= cutoff):
            self.sim.schedule_at(up, UPLOAD_DONE, i, ("uplink", r_u))
        return dl, cp, up

    def _merge_grouped(self, buffer: List[int], pending: Dict, w: np.ndarray,
                       merge_key, full_round: bool) -> np.ndarray:
        """One grouped engine step over an async merge buffer.

        The buffer's K arrivals are partitioned by sub-model shape; canvas
        rows (and the mask-key fold ids) are the BUFFER positions,
        mirroring the homogeneous async path, and staleness-decayed
        weights index by the same rows.
        """
        from repro_torch.fl.heterogeneity import group_by_shape
        dev = self.device
        groups = group_by_shape([pending[i][1] for i in buffer])
        batches = []
        for grp in groups:
            members = [buffer[pos] for pos in grp.indices]
            idx = np.asarray(grp.indices, np.int64)
            batches.append(round_engine.GroupBatch(
                indices=idx,
                stacked_old=round_engine.stack_pytrees(
                    [pending[i][0] for i in members]),
                stacked_new=round_engine.stack_pytrees(
                    [pending[i][1] for i in members]),
                coverage=(None if self._dense
                          else self._client_coverage[members[0]]),
                dropout=stage(np.asarray([pending[i][3] for i in members],
                                         np.float32), torch.float32, dev),
                rows=stage(idx, torch.int64, dev)))
        out = self.grouped_engine.step(
            batches, self.global_params,
            stage(np.asarray(w, np.float32), torch.float32, dev), merge_key,
            full_round=full_round, dense_masks=self._dense)
        self.global_params = out.global_params
        for grp, stacked in zip(groups, out.group_client_params):
            for pos, p in zip(grp.indices,
                              round_engine.unstack_pytree_copies(
                                  stacked, grp.size)):
                self.client_params[buffer[pos]] = p
        dens, oh = self.obs.to_host(_to_host, out.densities,
                                    out.wire_overhead)
        return np.asarray(dens, float), oh

    def _result(self, history: List[RoundRecord]) -> SimResult:
        return SimResult(history=history, global_params=self.global_params,
                         event_trace=list(self.sim.trace),
                         observed_telemetry=self.observed.telemetry(
                             np.ones(self.tel.num_clients)))

    # -- crash-resume snapshots (repro_torch.checkpoint) ---------------------

    def _wave_snapshot(self, losses: np.ndarray) -> Dict:
        """Everything the next wave round reads, as one checkpointable
        pytree: per-client params (unstacked — the fleet re-stacks them
        identically on resume), global params, the protocol PRNG key,
        the loss view, the allocated D_{t+1}, and the observed-telemetry
        EWMAs.  The sim clock + event trace ride the sidecar (extras);
        fault / outage / network draws are keyed per epoch and need no
        persisting."""
        return {"clients": self.client_params,
                "global": self.global_params,
                "rng": np.asarray(self.rng),
                "losses": np.asarray(losses, np.float64),
                "dropout": np.asarray(self.dropout, np.float64),
                "obs_uplink": self.observed.uplink,
                "obs_downlink": self.observed.downlink,
                "obs_compute": self.observed.compute}

    def _wave_restore(self, arrays: Dict) -> np.ndarray:
        """Inverse of :meth:`_wave_snapshot`; returns the loss view."""
        self.client_params = [convert.to_torch(p, self.device)
                              for p in arrays["clients"]]
        self.global_params = convert.to_torch(arrays["global"], self.device)
        self.rng = np.asarray(arrays["rng"], np.uint32)
        self.dropout = np.asarray(arrays["dropout"], np.float64)
        self.observed.uplink = np.asarray(arrays["obs_uplink"], float)
        self.observed.downlink = np.asarray(arrays["obs_downlink"], float)
        self.observed.compute = np.asarray(arrays["obs_compute"], float)
        return np.asarray(arrays["losses"], np.float64)

    def _maybe_checkpoint(self, t: int, fleet, losses: np.ndarray,
                          history: List[RoundRecord]) -> None:
        """Atomic RunState snapshot after round ``t`` when due
        (``checkpoint_every=None`` never reaches the fleet export)."""
        cfg = self.cfg
        if cfg.checkpoint_every is None or t % cfg.checkpoint_every:
            return
        from repro_torch import checkpoint as ckpt_mod
        self.client_params = fleet.export()
        ckpt_mod.save_run_state(cfg.checkpoint_path, ckpt_mod.RunState(
            round=t, arrays=self._wave_snapshot(losses), history=history,
            extra={"sim_time": float(self.sim.now),
                   "trace": [list(e) for e in self.sim.trace]}))

    # -- wave policies: sync / deadline / retry ------------------------------

    def run_waves(self, local_train_fn: Callable, eval_fn=None,
                  rounds: Optional[int] = None) -> SimResult:
        self.obs = obs_mod.make_recorder(
            self.cfg.obs, driver="sim", device=self.device,
            scheme=self.cfg.scheme,
            policy=str(self.simcfg.policy),
            clients=self.tel.num_clients,
            rounds=rounds or self.cfg.rounds)
        try:
            return self._run_waves_impl(local_train_fn, eval_fn, rounds)
        finally:
            self.obs.close()
            self.obs = obs_mod.NULL_RECORDER

    def _cohort_train_fn(self, local_train_fn: Callable) -> Callable:
        """Population mode: the fleets hand ``local_train_fn`` a COHORT
        stack position; user train fns are written against global client
        ids (their data shard).  Translate at the boundary, reading
        ``self.cohort`` at call time so retargets are picked up.  The key
        stays the fleet's position-folded key either way."""
        if self.population is None:
            return local_train_fn

        def wrapped(p, i, key):
            return local_train_fn(p, int(self.cohort[i]), key)

        return wrapped

    def _run_waves_impl(self, local_train_fn: Callable, eval_fn=None,
                        rounds: Optional[int] = None) -> SimResult:
        cfg = self.cfg
        obs = self.obs
        dev = self.device
        local_train_fn = self._cohort_train_fn(local_train_fn)
        rounds = rounds or cfg.rounds
        n = self.tel.num_clients
        losses = np.ones(n)
        history: List[RoundRecord] = []
        sim = self.sim
        # crash-resume: restore BEFORE the fleet stacks client state, so
        # the wave fleet is built from the snapshot; fault / outage /
        # network draws are keyed per epoch and replay from start_t
        start_t = 1
        if cfg.resume_from:
            from repro_torch import checkpoint as ckpt_mod
            st = ckpt_mod.load_run_state(cfg.resume_from,
                                         self._wave_snapshot(losses))
            losses = self._wave_restore(st.arrays)
            history = st.history
            start_t = st.round + 1
            sim.advance_to(float(st.extra.get("sim_time", 0.0)))
            sim.trace[:] = [tuple(e) for e in st.extra.get("trace", [])]
        fleet = self._make_fleet()
        partial_on = (isinstance(self.policy, DeadlinePolicy)
                      and self.policy.partial)

        for t in range(start_t, rounds + 1):
            host0 = time.perf_counter()
            # population mode: (re)sample the cohort BEFORE the protocol
            # key splits, so the key schedule is untouched and a static
            # cohort stays bit-identical to the plain fleet run
            if self.population is not None:
                fleet, losses = self._retarget_cohort(t, fleet, losses)
            self.rng, rk = prng.split(self.rng)
            part = self._participants(losses)
            d_used = self.dropout.copy()
            d_time = d_used if cfg.scheme == "feddd" else np.zeros(n)

            # --- device math: local training (participants)
            with obs.span("local_train", round=t):
                loss_dev = fleet.train(local_train_fn, rk, part, losses,
                                       d_used)

            # --- event timeline with TRUE conditions of this epoch; the
            # uplink leg moves the codec's bytes (repro_torch.comm)
            _transport0 = time.perf_counter()
            cond = self._conditions(t - 1)
            true_tel = telemetry_with_conditions(self.tel, cond)
            up_wire = self._uplink_wire_vec(d_time)
            ti = baselines.round_times(true_tel, d_time,
                                       uplink_bytes=up_wire)
            wire_vec = (np.asarray(up_wire, float)
                        if up_wire is not None else
                        np.asarray(self.tel.model_bytes, float)
                        * (1.0 - d_time))
            # --- this epoch's fault draw (sim/faults.py), charged real
            # codec bytes; None leaves the schedule bit-identical
            fr = (self.faults.round_faults(
                t - 1, wire_vec, np.asarray(cond.uplink_rate, float))
                if self.faults is not None else None)
            if fr is not None and obs.active:
                for inc in faults_mod.incident_events(fr, part):
                    obs.fault(t, inc)
            dispatch = sim.now
            spans = {}
            for i in np.flatnonzero(part):
                i = int(i)
                if fr is None:
                    spans[i] = self._schedule_round_trip(
                        i, dispatch, float(d_time[i]), cond,
                        total=float(ti[i]))
                elif fr.crashed[i]:
                    # the client dies at crash_frac of its round trip:
                    # later events are never scheduled, the upload never
                    # arrives, its telemetry estimates go stale
                    spans[i] = self._schedule_round_trip(
                        i, dispatch, float(d_time[i]), cond,
                        total=float(ti[i]),
                        cutoff=dispatch + float(fr.crash_frac[i])
                        * float(ti[i]),
                        drop_upload=True)
                else:
                    # lossy uplink: retransmits + backoff push the
                    # arrival back on the Eq. (12) clock; an exhausted
                    # retry budget abandons the upload entirely
                    spans[i] = self._schedule_round_trip(
                        i, dispatch, float(d_time[i]), cond,
                        total=float(ti[i]),
                        extra_delay=float(fr.extra_delay[i]),
                        drop_upload=bool(fr.aborted[i]))

            # --- the server listens until the policy's horizon: deadlines
            # bind on the EXPECTED real payloads (codec bytes over the
            # observed links)
            expected = baselines.round_times(
                self.observed.telemetry(losses), d_time,
                uplink_bytes=up_wire)[part]
            deadline = dispatch + self.policy.horizon(expected)
            dead = (part & (fr.crashed | fr.aborted) if fr is not None
                    else np.zeros(n, bool))
            n_expected = int(np.sum(part & ~dead))
            arrived = np.zeros(n, bool)
            arr_time = np.full(n, np.inf)
            while sim.queue and sim.queue.peek().time <= deadline:
                # a fault-aware server stops listening once every upload
                # that can still arrive has
                if (fr is not None and n_expected
                        and int(arrived.sum()) >= n_expected):
                    break
                ev = sim.step()
                self.observed.observe(ev)
                if ev.kind == UPLOAD_DONE:
                    arrived[ev.client] = True
                    arr_time[ev.client] = ev.time
            if fr is None and not arrived.any():
                # never aggregate an empty fault-free round; with a fault
                # model attached the quorum rule below owns this case
                while sim.queue:
                    ev = sim.step()
                    self.observed.observe(ev)
                    if ev.kind == UPLOAD_DONE:
                        arrived[ev.client] = True
                        arr_time[ev.client] = ev.time
                        break
            # late stragglers: in-flight transfers are abandoned (their
            # uplink estimate stays stale — the server never saw it land)
            sim.queue.clear()
            late = part & ~arrived
            cut = late & ~dead          # alive, just past the horizon
            if arrived.any():
                round_end = float(np.max(arr_time[arrived]))
                if cut.any():
                    round_end = max(round_end, float(deadline))
            else:
                round_end = (float(deadline) if np.isfinite(deadline)
                             else float(sim.now))
            round_end = max(round_end, float(sim.now))
            sim.advance_to(round_end)
            obs.span_done("transport", _transport0, round=t)

            # --- delivered prefixes of cut uploads (deadline partial
            # aggregation) and the bytes wasted by transfers that died
            # in flight; progress over the upload window is modelled
            # uniform in time
            partial = np.zeros(n, bool)
            delivered_rows: Dict[int, np.ndarray] = {}
            partial_bytes = 0.0
            abandoned_b = 0.0
            if cut.any() and np.isfinite(deadline):
                for i in np.flatnonzero(cut):
                    i = int(i)
                    _, cp_t, up_t = spans[i]
                    if deadline <= cp_t or up_t <= cp_t:
                        continue              # upload had not started
                    frac = min((deadline - cp_t) / (up_t - cp_t), 1.0)
                    db = float(wire_vec[i]) * frac
                    if partial_on:
                        counts = delivered_prefix_counts(
                            self.wire_specs[i], float(d_time[i]),
                            cfg.comm, db)
                        if counts.sum() > 0:
                            partial[i] = True
                            delivered_rows[i] = counts
                            partial_bytes += db
                            continue
                    abandoned_b += db
            if fr is not None:
                abandoned_b += float(np.sum(fr.sent_bytes[part]))
                for i in np.flatnonzero(part & fr.crashed):
                    i = int(i)
                    _, cp_t, up_t = spans[i]
                    cutoff = dispatch + float(fr.crash_frac[i]) \
                        * float(ti[i])
                    if cutoff > cp_t and up_t > cp_t:
                        abandoned_b += float(wire_vec[i]) * min(
                            (cutoff - cp_t) / (up_t - cp_t), 1.0)

            # --- payload validation: non-finite / norm-anomalous
            # arrivals are quarantined (0 weight on the stacked Eq. (4)
            # step — the baselines' non-participation mechanism)
            quarantine = np.zeros(n, bool)
            overrides: Dict[int, object] = {}
            quarantined_b = 0.0
            contributors = arrived | partial
            if fr is not None and contributors.any():
                norms, finite = fleet.upload_stats()
                for i in np.flatnonzero(arrived & (fr.corrupt > 0)):
                    i = int(i)
                    old_row, new_row = fleet.row_params(i)
                    kind = faults_mod.CORRUPT_KINDS[int(fr.corrupt[i]) - 1]
                    crow = faults_mod.corrupt_pytree(
                        new_row, kind, faults_mod.corruption_rng(
                            self.faults.config.seed, t - 1, i))
                    norms[i], finite[i] = faults_mod.host_update_stats(
                        crow, old_row)
                    overrides[i] = crow
                quarantine = faults_mod.screen_quarantine(
                    norms, finite, contributors,
                    self.faults.config.validation)
                # corrupted uploads the screen MISSED reach the canvas;
                # screened ones never do
                overrides = {i: p for i, p in overrides.items()
                             if not quarantine[i]}
                quarantined_b = float(np.sum(
                    (wire_vec + fr.extra_bytes)[arrived & quarantine]))
                if obs.active:
                    for i in np.flatnonzero(arrived & quarantine):
                        obs.fault(t, {"kind": "quarantine",
                                      "client": int(i),
                                      "norm": float(norms[i]),
                                      "finite": bool(finite[i])})
            valid = arrived & ~quarantine
            partial &= ~quarantine
            contributors = valid | partial
            survivors = int(np.sum(part & ~(
                fr.crashed if fr is not None else np.zeros(n, bool))))
            retries_n = int(np.sum(fr.retries[part])) if fr is not None \
                else 0

            # --- minimum quorum: below the floor the round is SKIPPED —
            # global and client params held, arrivals discarded, and the
            # allocation LP re-solved on survivor-only telemetry
            if fr is not None and int(contributors.sum()) \
                    < self.faults.quorum_floor(int(part.sum())):
                fleet.discard()
                abandoned_b += partial_bytes + float(np.sum(
                    (wire_vec + fr.extra_bytes)[valid]))
                # nobody contributed to a committed aggregate, but the
                # arrivals' bytes travelled — the store's economy (and
                # the seen flags) must reflect the contact
                self._population_round_done(
                    t, part, fr, wire_vec, losses,
                    contributors=np.zeros(n, bool), moved=arrived)
                if cfg.scheme == "feddd":
                    with obs.span("allocate", round=t):
                        self._allocate(losses, alive=~fr.crashed)
                metrics = (eval_fn(self.global_params)
                           if eval_fn and t % self.simcfg.eval_every == 0
                           else None)
                history.append(RoundRecord(
                    round=t, sim_time=round_end,
                    sim_round_time=round_end - dispatch,
                    host_wall_time=time.perf_counter() - host0,
                    mean_loss=float(np.mean(losses)),
                    dropout_rates=self.dropout.copy(),
                    uploaded_fraction=0.0, uploaded_bytes=0.0,
                    wire_bytes=0.0, participants=0,
                    survivors=survivors, retries=retries_n,
                    abandoned_bytes=abandoned_b,
                    quarantined_bytes=quarantined_b,
                    skipped=True, metrics=metrics))
                if obs.active:
                    obs.fault(t, {
                        "kind": "quorum_skip",
                        "contributors": int(contributors.sum()),
                        "floor": self.faults.quorum_floor(
                            int(part.sum()))})
                    obs.round(history[-1], path="sim", scheme=cfg.scheme,
                              client_times=np.where(
                                  arrived, arr_time - dispatch, np.nan))
                self._maybe_checkpoint(t, fleet, losses, history)
                continue

            # --- fused engine step: exclusion == 0 aggregation weight;
            # partial clients keep their weight but only their delivered
            # mask-channel prefix aggregates
            delivered_arg = None
            if partial.any():
                n_leaves = len(self.wire_specs[0].leaves)
                mat = np.full((n_leaves, n), np.iinfo(np.int32).max,
                              np.int32)
                for i, counts in delivered_rows.items():
                    if partial[i]:
                        mat[:, i] = counts
                staged = stage(mat, torch.int32, dev)
                delivered_arg = tuple(staged[li] for li in range(n_leaves))
            weights = stage(np.asarray(self.weights * contributors,
                                       np.float32), torch.float32, dev)
            with obs.span("engine_step", round=t):
                densities, wire_oh = fleet.step(
                    stage(np.asarray(d_used, np.float32), torch.float32,
                          dev), weights, rk,
                    full_round=(t % cfg.h == 0) or self._dense,
                    dense=self._dense, delivered=delivered_arg,
                    overrides=overrides)
            with obs.span("host_transfer", round=t):
                dens, oh, loss_host = obs.to_host(_host_round, densities,
                                                  wire_oh, loss_dev)
            # the loss report ships WITH the upload: a straggler whose
            # transfer was abandoned (or quarantined) keeps its stale
            # loss server-side
            losses = np.where(valid, loss_host, losses)
            uploaded, wire = account_uplink(dens, valid,
                                            self.tel.model_bytes, oh,
                                            cfg.comm, obs=obs)
            wire += partial_bytes
            if fr is not None:
                wire += float(np.sum(fr.extra_bytes[valid]))
            if self.mesh is not None and not self.heterogeneous:
                account_collective(
                    self._global_spec, self.engine.num_shards,
                    mode=cfg.mesh_collective,
                    k_fraction=cfg.mesh_keep_fraction, obs=obs)

            # --- population write-back BEFORE the t+1 allocation, so a
            # cold-start solve already sees this round's first contacts
            self._population_round_done(
                t, part, fr, wire_vec, losses,
                contributors=contributors, moved=contributors)

            # --- allocation for round t+1, from what the server observed.
            # A correlated outage (sim/outages.py) excludes its cells
            # wholesale: the LP re-solves on survivor-only telemetry and
            # the downed cells keep their previous rates
            if cfg.scheme == "feddd":
                om = (self.faults.outage_mask(t - 1)
                      if self.faults is not None else None)
                with obs.span("allocate", round=t):
                    self._allocate(losses,
                                   alive=(~om if om is not None
                                          and om.any() else None))

            if eval_fn and t % self.simcfg.eval_every == 0:
                with obs.span("eval", round=t):
                    metrics = eval_fn(self.global_params)
            else:
                metrics = None
            history.append(RoundRecord(
                round=t, sim_time=round_end,
                sim_round_time=round_end - dispatch,
                host_wall_time=time.perf_counter() - host0,
                mean_loss=float(np.mean(losses)),
                dropout_rates=self.dropout.copy(),
                uploaded_fraction=uploaded / max(self.full_bytes, 1e-9),
                uploaded_bytes=uploaded, wire_bytes=wire,
                participants=int(np.sum(contributors)),
                survivors=survivors, retries=retries_n,
                abandoned_bytes=abandoned_b,
                quarantined_bytes=quarantined_b,
                metrics=metrics))
            if obs.active:
                # per-client upload-completion offsets on the sim clock:
                # the straggler timeline (NaN = never landed this round)
                obs.round(history[-1], path="sim", scheme=cfg.scheme,
                          client_times=np.where(
                              arrived, arr_time - dispatch, np.nan))
            self._maybe_checkpoint(t, fleet, losses, history)

        self.client_params = fleet.export()
        if self.population is not None:
            self.population.fold_back(self.cohort, self.client_params,
                                      dropout=self.dropout, losses=losses)
        return self._result(history)

    # -- buffered fully-async policy ------------------------------------------

    def run_async(self, local_train_fn: Callable, eval_fn=None,
                  rounds: Optional[int] = None) -> SimResult:
        """FedBuff-style serving: merge every ``buffer_size`` arrivals with
        staleness-decayed weights; merged clients re-dispatch immediately.

        One history record per merge ("virtual round"); ``sim_time`` is
        the merge's arrival-complete time, so fast clients lap stragglers
        instead of the fleet idling at Eq. (12)'s max.
        """
        self.obs = obs_mod.make_recorder(
            self.cfg.obs, driver="sim", device=self.device,
            scheme=self.cfg.scheme,
            policy=str(self.simcfg.policy),
            clients=self.tel.num_clients,
            rounds=rounds or self.cfg.rounds)
        try:
            return self._run_async_impl(local_train_fn, eval_fn, rounds)
        finally:
            self.obs.close()
            self.obs = obs_mod.NULL_RECORDER

    def _run_async_impl(self, local_train_fn: Callable, eval_fn=None,
                        rounds: Optional[int] = None) -> SimResult:
        cfg = self.cfg
        obs = self.obs
        dev = self.device
        rounds = rounds or cfg.rounds
        n = self.tel.num_clients
        k_buf = self.policy.resolved_buffer(n)
        sim = self.sim
        losses = np.ones(n)
        history: List[RoundRecord] = []
        version = 0
        merges = 0
        epochs = np.zeros(n, int)             # per-client dispatch count
        dispatch_version = np.zeros(n, int)
        pending: Dict[int, tuple] = {}        # i -> (old, new, loss, d_i)
        train_key = prng.fold_in(self.rng, 0)
        agg_key = prng.fold_in(self.rng, 1)
        seq = 0
        # async fault bookkeeping (sim/faults.py): draws are keyed by the
        # client's OWN dispatch epoch, so the stream is independent of
        # merge interleaving and replay-identical across processes
        faults = self.faults
        budget = (faults.config.staleness_budget
                  if faults is not None else 0)
        pend_wire = np.zeros(n)      # codec bytes of the pending upload
        pend_extra = np.zeros(n)     # retransmitted duplicate bytes
        abandoned_acc = 0.0
        retries_acc = 0
        no_progress = 0

        def dispatch(i: int) -> None:
            nonlocal seq, abandoned_acc, retries_acc
            e = int(epochs[i])
            cond = self.network.conditions(e)
            epochs[i] += 1
            d_i = float(self.dropout[i]) if cfg.scheme == "feddd" else 0.0
            p_new, loss = local_train_fn(
                self.client_params[i], i, prng.fold_in(train_key, seq))
            seq += 1
            pending[i] = (self.client_params[i], p_new, loss, d_i)
            dispatch_version[i] = version
            pend_extra[i] = 0.0
            pend_wire[i] = (
                float(self.tel.model_bytes[i]) * (1.0 - d_i)
                if cfg.comm.is_default else
                float(analytic_uplink_vector([self.wire_specs[i]],
                                             np.asarray([d_i]),
                                             cfg.comm)[0]))
            if faults is None:
                self._schedule_round_trip(i, sim.now, d_i, cond)
                return
            fr = faults.round_faults(e, np.full(n, pend_wire[i]),
                                     np.asarray(cond.uplink_rate, float))
            if fr.crashed[i]:
                # the client dies mid-trip; its upload never arrives and
                # the CLIENT_DOWN marker re-enters the slot at the crash
                # instant
                t0 = sim.now
                _, cp_t, up_t = self._schedule_round_trip(
                    i, t0, d_i, cond, crash_frac=float(fr.crash_frac[i]))
                cutoff = t0 + float(fr.crash_frac[i]) * (up_t - t0)
                if cutoff > cp_t and up_t > cp_t:
                    abandoned_acc += pend_wire[i] * min(
                        (cutoff - cp_t) / (up_t - cp_t), 1.0)
                if obs.active:
                    obs.fault(merges + 1, {
                        "kind": "crash", "client": int(i),
                        "crash_frac": float(fr.crash_frac[i])})
            elif fr.aborted[i]:
                # retransmit budget exhausted: the bytes already sent are
                # wasted and the slot re-enters when the client gives up
                _, _, up_t = self._schedule_round_trip(
                    i, sim.now, d_i, cond,
                    extra_delay=float(fr.extra_delay[i]),
                    drop_upload=True)
                sim.schedule_at(up_t, CLIENT_DOWN, i)
                abandoned_acc += float(fr.sent_bytes[i])
                retries_acc += int(fr.retries[i])
                if obs.active:
                    obs.fault(merges + 1, {
                        "kind": "abort", "client": int(i),
                        "retries": int(fr.retries[i]),
                        "sent_bytes": float(fr.sent_bytes[i])})
            else:
                if fr.retries[i]:
                    retries_acc += int(fr.retries[i])
                    pend_extra[i] = float(fr.extra_bytes[i])
                self._schedule_round_trip(
                    i, sim.now, d_i, cond,
                    extra_delay=float(fr.extra_delay[i]))

        for i in range(n):
            dispatch(i)
        buffer: List[int] = []
        prev_time = 0.0
        host_prev = time.perf_counter()

        while merges < rounds and sim.queue:
            ev = sim.step()
            self.observed.observe(ev)
            if ev.kind == CLIENT_DOWN:
                # crash/abort became known: the slot re-enters now.  The
                # counter guards the degenerate every-dispatch-dies
                # config, which would otherwise spin forever
                no_progress += 1
                if no_progress > 10_000 * max(n, 1):
                    raise RuntimeError(
                        "async run is making no progress: every "
                        "re-dispatched client crashed or aborted "
                        f"{no_progress} times in a row — lower "
                        "crash_rate / loss_rate")
                dispatch(ev.client)
                continue
            if ev.kind != UPLOAD_DONE:
                continue
            no_progress = 0
            buffer.append(ev.client)
            losses[ev.client] = float(pending[ev.client][2])
            if len(buffer) < k_buf:
                continue

            # --- staleness budget (FaultConfig.staleness_budget): the
            # buffered-async analogue of the wave quorum
            if faults is not None and budget:
                stale = (version - dispatch_version[buffer]) > budget
                if stale.any():
                    for i in np.asarray(buffer)[stale]:
                        i = int(i)
                        abandoned_acc += pend_wire[i] + pend_extra[i]
                        if obs.active:
                            obs.fault(merges + 1, {
                                "kind": "stale_drop", "client": i,
                                "staleness": int(version
                                                 - dispatch_version[i]),
                                "budget": int(budget)})
                        dispatch(i)
                    buffer = [i for i, s in zip(buffer, stale) if not s]
                if len(buffer) < faults.quorum_floor(k_buf):
                    continue

            # --- merge the buffer: one engine step over K clients
            merges += 1
            staleness = version - dispatch_version[buffer]
            scale = self.policy.staleness_scale(staleness)
            w = self.weights[buffer] * scale
            merge_key = prng.fold_in(agg_key, merges)
            full_round = (merges % cfg.h == 0) or self._dense
            with obs.span("engine_step", round=merges):
                if self.heterogeneous:
                    dens, oh = self._merge_grouped(buffer, pending, w,
                                                   merge_key, full_round)
                else:
                    olds = round_engine.stack_pytrees(
                        [pending[i][0] for i in buffer])
                    news = round_engine.stack_pytrees(
                        [pending[i][1] for i in buffer])
                    d_vec = stage(np.asarray([pending[i][3]
                                              for i in buffer], np.float32),
                                  torch.float32, dev)
                    out = self.engine.step(
                        olds, news, self.global_params, d_vec,
                        stage(np.asarray(w, np.float32), torch.float32, dev),
                        merge_key, full_round=full_round,
                        dense_masks=self._dense)
                    self.global_params = out.global_params
                    dens, oh = self.obs.to_host(_to_host, out.densities,
                                                out.wire_overhead)
                    dens = np.asarray(dens, float)
                    # copies: a kept row must not pin the merge's stack
                    for i, row in zip(buffer,
                                      round_engine.unstack_pytree_copies(
                                          out.client_params, len(buffer))):
                        self.client_params[i] = row
            version += 1
            uploaded, wire = account_uplink(
                dens, np.ones(len(buffer), bool),
                self.tel.model_bytes[buffer], oh, cfg.comm, obs=obs)
            if faults is not None:
                # surviving retransmits moved duplicate bytes on the wire
                wire += float(np.sum(pend_extra[buffer]))

            if cfg.scheme == "feddd":
                with obs.span("allocate", round=merges):
                    self._allocate(losses)
            metrics = (eval_fn(self.global_params)
                       if eval_fn and merges % self.simcfg.eval_every == 0
                       else None)
            history.append(RoundRecord(
                round=merges, sim_time=ev.time,
                sim_round_time=ev.time - prev_time,
                host_wall_time=time.perf_counter() - host_prev,
                mean_loss=float(np.mean(losses)),
                dropout_rates=self.dropout.copy(),
                uploaded_fraction=uploaded / max(self.full_bytes, 1e-9),
                uploaded_bytes=uploaded, wire_bytes=wire,
                participants=len(buffer), survivors=len(buffer),
                retries=retries_acc, abandoned_bytes=abandoned_acc,
                metrics=metrics))
            if obs.active:
                obs.round(history[-1], path="sim_async",
                          scheme=cfg.scheme)
            prev_time = ev.time
            host_prev = time.perf_counter()
            retries_acc, abandoned_acc = 0, 0.0

            for i in buffer:
                dispatch(i)     # re-enter immediately: no fleet barrier
            buffer = []

        return self._result(history)


def _host_round(densities: torch.Tensor, wire_oh, losses: List):
    """The wave round's one device-to-host copy: densities, overhead and
    the trainer's losses (host floats, or 0-D tensors that ride the same
    buffer) -> (densities, overhead or None, (N,) float64 losses)."""
    if all(isinstance(l, torch.Tensor) for l in losses):
        dens, oh, lh = _to_host(densities, wire_oh,
                                torch.stack([l.float().reshape(())
                                             for l in losses]))
        return dens, oh, np.asarray(lh, float)
    dens, oh = _to_host(densities, wire_oh)
    return dens, oh, np.asarray([float(l) for l in losses], float)


def run_sim(scheme: str, global_params, telemetry: ClientTelemetry,
            local_train_fn: Callable, eval_fn=None, *,
            sim: Optional[SimConfig] = None,
            network: Optional[NetworkModel] = None,
            client_params: Optional[List] = None,
            faults: Optional[FaultModel] = None,
            population=None, cohort_size: Optional[int] = None,
            rounds: Optional[int] = None, device: DeviceLike = None,
            **cfg_kw) -> SimResult:
    """One-call driver, mirroring :func:`repro_torch.core.protocol
    .run_scheme`.  Runs on ``cuda`` unless ``device`` says otherwise.

    Args:
      scheme: feddd | fedavg | fedcs | oort.  Selection baselines
        (fedcs/oort) are evaluated on the server's observed telemetry and
        are wave-only: combining them with the async policy raises.
      sim: :class:`SimConfig` — policy + observation knobs.
      network: a :class:`repro_torch.sim.network.NetworkModel`; defaults
        to :class:`StaticNetwork` over ``telemetry`` (the paper's setting).
      client_params: optional per-client sub-model pytrees (ragged widths,
        HeteroFL-style slices of ``global_params``); the runner partitions
        them by shape and drives the grouped engine.
      faults: a :class:`repro_torch.sim.faults.FaultModel` — client churn,
        lossy uplinks, corrupted payloads, quorum-gated degradation, and
        the correlated cell-outage overlay
        (:class:`repro_torch.sim.outages.CellOutageModel`).  ``None``
        leaves every run bit-identical to the fault-free simulator.
        Crash / loss / retry channels and the staleness-budget quorum also
        apply to the async policy; payload corruption stays wave-only.
      population: a :class:`repro_torch.population.Population` —
        ``telemetry`` (and ``network``/``client_params``, when given) then
        cover the POPULATION, and each round materializes only the sampled
        ``cohort_size`` clients into engine buffers.  A population the
        size of the fleet with always-on availability and the identity
        sampler is bit-identical to the plain fleet run.  Wave policies
        only.
      cohort_size: clients per round (default: the whole population).
      **cfg_kw: ProtocolConfig fields (rounds, a_server, d_max, delta, h,
        seed, selection, allocator, comm, obs, robust_agg,
        checkpoint_every, checkpoint_path, resume_from — the last three
        drive bit-identical crash-resume of wave-policy runs; see
        repro_torch.checkpoint).
    """
    simcfg = sim or SimConfig()
    if rounds is not None:
        cfg_kw["rounds"] = rounds
    cfg_kw.pop("batched", None)       # the sim runner is always batched
    if population is not None:
        cfg_kw.setdefault("population", population.size)
        cfg_kw.setdefault("cohort_size",
                          cohort_size if cohort_size is not None
                          else population.size)
    elif cohort_size is not None:
        raise ValueError("cohort_size requires population=")
    cfg = ProtocolConfig(scheme=scheme, **cfg_kw)
    runner = SimRunner(global_params, cfg, telemetry, simcfg, network,
                       client_params=client_params, faults=faults,
                       population=population,
                       cohort_size=cfg.cohort_size, device=device)
    if isinstance(runner.policy, AsyncPolicy):
        if scheme in ("fedcs", "oort"):
            raise ValueError(
                f"scheme {scheme!r} is a per-round client-selection "
                "baseline; it has no async analogue (use sync/deadline, "
                "or feddd/fedavg with async)")
        return runner.run_async(local_train_fn, eval_fn, cfg.rounds)
    return runner.run_waves(local_train_fn, eval_fn, cfg.rounds)
