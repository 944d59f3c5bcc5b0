"""Batched FedDD round engine — the homogeneous hot path on the card.

Client parameter pytrees stack along a leading client axis, and one call
runs the server side of a round over the whole fleet:

    importance scoring   — importance kernel, one launch per leaf
    mask building        — a stable descending sort per client row and a
                           ``rank < keep`` compare
    masked aggregation   — Eq. (4), sparse_agg kernel, one launch per leaf
    client update        — Eq. (5), masked_merge kernel, one launch for
                           every leaf (or Eq. (6) on full rounds)

The per-round device-to-host traffic is the (N,) density vector, and
with a non-default wire format the (N,) measured mask overhead.  With
``qbits < 32`` the aggregation reads the quantize-dequantized uploads
(threefry-keyed int8 stochastic rounding, :mod:`repro_torch.comm`), while
Eq. (5) keeps each client's own full-precision values.

The engine also serves the FedAvg, FedCS and Oort baselines
(``dense_masks``: all-ones masks, no scoring); non-participation is a 0
aggregation weight.  ``robust_agg`` picks the Eq. (4) variant
(``core/aggregation.py``).

Multi-round path (:meth:`BatchedRoundEngine.run`): with a device-fused
trainer (``batched_train_fn``, e.g. :func:`make_batched_train_fn`) and
the float32 allocator (``allocation.solve_dropout_rates_torch``), K whole
rounds — training, participation, masks, Eq. (4)-(6), the Eq. (9)-(11)
re-allocation and the Eq. (12) clock — run back to back with no host
sync: a Python loop over the rounds that issues the same operations the
per-round path issues, so the two agree bit for bit, and returns the K
rounds' telemetry as one device-resident :class:`ScanTrace` the caller
fetches in one transfer.  Round keys stay host numpy (``prng``); their
split chain does not depend on device data.

Fault injection (the simulator, :mod:`repro_torch.sim`): ``stacked_upload``
is what the server decoded off the wire — corrupted rows the validation
screen let through — and feeds the aggregation, while Eq. (5) keeps the
clients' clean ``stacked_new``; ``delivered`` cuts deadline-truncated
uploads to the per-leaf prefix of kept channels that landed
(``aggregation.truncate_masks_to_prefix``), for Eq. (4) only.  With both
None a step issues exactly the operations of a fault-free one.

Ragged fleets (:class:`GroupedRoundEngine`): clients holding width-pruned
sub-models are partitioned by shape (``fl.heterogeneity.group_by_shape``)
and each group stacks along a member axis.  One step runs, per group,
the coverage-aware masks at the group's own widths (importance with the
Eq. (21) coverage division, one launch per group and leaf), then Eq. (4)
once over the full-width canvas of every client (the sparse_agg
kernel's elementwise-mask mode, one launch per leaf), then Eq. (5) per
group at local widths (one masked_merge launch per group).  Its oracle is
the per-client loop (``protocol``'s loop executor on a ragged fleet): the
same masks, parameters and clock bit for bit.

Client-sharded rounds (:class:`ShardedRoundEngine`, and
``GroupedRoundEngine(mesh=)``): the client axis (a group's member axis)
splits into contiguous blocks over the shards of a
:class:`~repro_torch.launch.mesh.ClientMesh`, one process driving every
shard as the JAX package's ``shard_map`` does.  Each shard runs the
round's phases on its rows — importance and masks with the rows' global
fleet ids, ``sparse_agg``'s partials mode, Eq. (5) through
``masked_merge`` — and the shards exchange only the Eq. (4) (num, den)
partials, summed or compacted (:mod:`repro_torch.core.sparse_collective`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng, tree
from repro_torch.comm import codecs as wire_codecs
from repro_torch.comm import quantize as wire_quant
from repro_torch.comm.payload import (CommConfig, WireSpec,
                                      analytic_wire_bytes)
from repro_torch.core import (aggregation, allocation, baselines, selection,
                              sparse_collective)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import ClientMesh
from repro_torch.obs.recorder import profiler_scope


class RoundOutputs(NamedTuple):
    """Results of one batched round step, on the parameters' device."""

    client_params: object      # pytree, leaves (N, *leaf): W_n^{t+1}
    global_params: object      # pytree: W^t
    densities: torch.Tensor    # (N,) fraction of elements uploaded
    wire_overhead: Optional[torch.Tensor] = None
                               # (N,) int32 measured mask/scale bytes;
                               # None with the default CommConfig
    collective_overflow: Optional[torch.Tensor] = None
                               # () float32 channels that missed the
                               # compacted cross-shard buffer
                               # (ShardedRoundEngine; 0 certifies the
                               # compaction lossless, and is always 0 for
                               # the dense collective)


class GroupBatch(NamedTuple):
    """One shape group's inputs to a grouped round step."""

    indices: np.ndarray        # (n_g,) host int64: fleet positions, the
                               # canvas rows and the ids the mask and
                               # quantization keys fold in
    stacked_old: object        # pytree, leaves (n_g, *local): W_n^t
    stacked_new: object        # pytree, leaves (n_g, *local): What_n^t
    coverage: object           # CR(k) pytree of (C_local,) float32
                               # leaves on the device, or None
    dropout: torch.Tensor      # (n_g,) float32 D_n^t on the device
    rows: Optional[torch.Tensor] = None
                               # ``indices`` as an int64 device tensor
                               # (staged once a run); None: copied in the
                               # step, a synchronising copy


class GroupedRoundOutputs(NamedTuple):
    """Results of one grouped round step, on the parameters' device."""

    group_client_params: Tuple     # per group: pytree, leaves (n_g, *local)
    global_params: object          # full-width pytree: W^t
    densities: torch.Tensor        # (N,) canvas of upload densities
    wire_overhead: Optional[torch.Tensor] = None
                                   # (N,) int32 canvas of measured mask /
                                   # scale bytes; None with the default comm


class ScanTelemetry(NamedTuple):
    """Static client telemetry of a scanned run, float32 on the device:
    the Eq. (9)-(11) allocator's inputs and the Eq. (12) clock's
    coefficients.  ``train_loss`` is round-dynamic and rides the
    :class:`ScanState` instead."""

    model_bytes: torch.Tensor      # (N,) U_n
    uplink_rate: torch.Tensor      # (N,) r_n^u
    downlink_rate: torch.Tensor    # (N,) r_n^d
    compute_latency: torch.Tensor  # (N,) t_n^cmp
    num_samples: torch.Tensor      # (N,) m_n
    label_coverage: torch.Tensor   # (N,) Eq. (13) coverage term

    @classmethod
    def from_host(cls, tel, device: DeviceLike = None) -> "ScanTelemetry":
        """Stage a ``ClientTelemetry`` (minus ``train_loss``) on
        ``device`` (default ``cuda``), rounded to float32 as the per-round
        "jax" allocator stages it."""
        dev = resolve_device(device)
        return cls(*(allocation.stage(getattr(tel, f), dev)
                     for f in cls._fields))


class ScanState(NamedTuple):
    """What round t hands round t+1 in a scanned chunk."""

    client_params: object          # stacked pytree, leaves (N, *leaf)
    global_params: object          # pytree: W^{t-1}
    losses: torch.Tensor           # (N,) float32 server-side loss view
    dropout: torch.Tensor          # (N,) float32 D_t, the next uploads'
    rng: np.ndarray                # protocol key (host), split each round
    sim_time: torch.Tensor         # () float32 device Eq. (12) clock,
                                   # from the chunk's start


class ScanTrace(NamedTuple):
    """The K rounds of a chunk, stacked on the device: the chunk's one
    device-to-host transfer (:meth:`to_host`).  ``round_time`` and
    ``sim_time`` are the float32 device rendering of the Eq. (12) clock;
    the protocol driver recomputes the float64 clock on the host from
    ``next_dropout`` and ``participants``, as the per-round path does."""

    losses: torch.Tensor           # (K, N) float32 post-round losses
    densities: torch.Tensor        # (K, N) float32 upload densities
    next_dropout: torch.Tensor     # (K, N) float32 D_{t+1}
    participants: torch.Tensor     # (K, N) bool
    round_time: torch.Tensor       # (K,) float32 Eq. (12) round time
    sim_time: torch.Tensor         # (K,) float32 cumulative device clock
    wire_overhead: Optional[torch.Tensor] = None
                                   # (K, N) int32 measured mask / scale
                                   # bytes; None with the default comm

    def to_host(self) -> "ScanTrace":
        """The same fields as numpy arrays, in one device-to-host copy
        (every field rides one float32 buffer; the int32 overhead as its
        bits)."""
        k, n = self.losses.shape
        parts = [self.losses, self.densities, self.next_dropout,
                 self.participants.float(), self.round_time.view(k, 1),
                 self.sim_time.view(k, 1)]
        if self.wire_overhead is not None:
            parts.append(self.wire_overhead.view(torch.float32))
        host = torch.cat(parts, dim=1).cpu().numpy()
        cols = np.cumsum([0, n, n, n, n, 1, 1])
        f = [host[:, a:b] for a, b in zip(cols[:-1], cols[1:])]
        oh = (None if self.wire_overhead is None
              else np.ascontiguousarray(host[:, cols[-1]:]).view(np.int32))
        return ScanTrace(f[0], f[1], f[2], f[3] > 0, f[4][:, 0], f[5][:, 0],
                         oh)


def stack_pytrees(trees: Sequence) -> object:
    """[pytree] x N (identical structure/shapes) -> pytree of (N, *leaf)."""
    return tree.tree_map(lambda *ls: torch.stack(ls), *trees)


def unstack_pytree(stacked, n: int) -> List:
    """Inverse of :func:`stack_pytrees` (views, no copies)."""
    return [tree.tree_map(lambda l: l[i], stacked) for i in range(n)]


def unstack_pytree_copies(stacked, n: int) -> List:
    """:func:`unstack_pytree` as copies: rows kept across rounds never pin
    (or alias) the whole stack."""
    return [tree.tree_map(lambda l: l[i].clone(), stacked)
            for i in range(n)]


def _adopt_global(new_global, stacked):
    """Eq. (6): every client adopts the fresh global model (materialised,
    so the next round's kernels read contiguous client stacks)."""
    return tree.tree_map(
        lambda g, l: g.to(l.dtype).expand(l.shape).contiguous(),
        new_global, stacked)


def keep_participants(part: torch.Tensor, stacked_new, stacked_old):
    """A vmapped trainer trains every row: non-participants ((N,) bool
    ``part`` false) go back to their stale rows."""
    return tree.tree_map(
        lambda new, old: torch.where(
            part.view((-1,) + (1,) * (new.ndim - 1)), new, old),
        stacked_new, stacked_old)


def _dense_masks(stacked, n: int):
    """All-ones channel masks + unit densities (full-model uploads)."""
    masks = tree.tree_map(
        lambda l: torch.ones((n,) + (1,) * (l.ndim - 1), dtype=l.dtype,
                             device=l.device), stacked)
    dev = tree.leaves(stacked)[0].device
    return masks, torch.ones((n,), dtype=torch.float32, device=dev)


def _wire_overhead(masks, stacked_new, comm: CommConfig, channel_axis: int,
                   dense_masks: bool) -> Optional[torch.Tensor]:
    """(N,) int32 measured mask/scale bytes, or None for the default comm.

    FedDD masks encode their kept sets; dense all-ones masks collapse the
    channel axis, so they charge the closed-form full-upload constant at
    the true channel widths."""
    if comm.is_default:
        return None
    first = tree.leaves(stacked_new)[0]
    if dense_masks:
        const = wire_codecs.full_upload_overhead_bytes(
            WireSpec.from_stacked(stacked_new, channel_axis), comm)
        return torch.full((first.shape[0],), const, dtype=torch.int32,
                          device=first.device)
    return wire_codecs.mask_overhead_bytes_stacked(masks, stacked_new, comm)


def _round_step(stacked_old, stacked_new, global_params, dropout_rates,
                weights, rng, stacked_upload=None, delivered=None, *,
                sel_cfg: selection.SelectionConfig,
                full_round: bool, dense_masks: bool = False,
                comm: CommConfig = CommConfig(),
                robust: str = "mean") -> RoundOutputs:
    """Steps 2-4 and 6-7 of Algorithm 1 over the stacked fleet; ``rng`` is
    the round key (scheme 'random' masks, int8 stochastic rounding).

    The phases carry the JAX engine's ``named_scope`` names as profiler
    scopes (``feddd_encode_masks``, ``feddd_encode_wire``,
    ``feddd_aggregate``, ``feddd_client_update``), entered only while a
    torch.profiler trace records."""
    with profiler_scope("feddd_encode_masks"):
        if dense_masks:
            n = tree.leaves(stacked_new)[0].shape[0]
            masks, density = _dense_masks(stacked_new, n)
        else:
            masks, density = selection.build_masks_batched(
                stacked_old, stacked_new, dropout_rates, config=sel_cfg,
                rng=rng)
    # the server aggregates what it decoded (the corrupted rows of a
    # faulty wire, when given) cut to the delivered prefixes; Eq. (5)
    # below keeps the clients' own full-precision values and full masks
    upload_src = stacked_new if stacked_upload is None else stacked_upload
    with profiler_scope("feddd_encode_wire"):
        stacked_agg = wire_quant.quantize_dequantize_stacked(
            upload_src, rng, comm.qbits)
        wire_oh = _wire_overhead(masks, stacked_new, comm,
                                 sel_cfg.channel_axis, dense_masks)
        agg_masks = (masks if delivered is None else
                     aggregation.truncate_masks_to_prefix(masks, delivered))
    # masks straight from the top-k compare: Eq. (4) as the JAX engine's
    # compiled step computes it (a masked-out term of a 1-D leaf adds
    # nothing); cut masks are a product there, the literal W * M * w
    with profiler_scope("feddd_aggregate"):
        new_global = aggregation.aggregate_sparse_stacked(
            stacked_agg, agg_masks, weights, prev_global=global_params,
            robust=robust, compiled=delivered is None)
    with profiler_scope("feddd_client_update"):
        if full_round:
            new_clients = _adopt_global(new_global, stacked_new)
        else:
            new_clients = aggregation.client_update_sparse(
                new_global, stacked_new, masks)
    return RoundOutputs(new_clients, new_global, density, wire_oh)


@dataclasses.dataclass
class BatchedRoundEngine:
    """FedDD rounds over client-stacked parameters: one round
    (:meth:`step`) or a chunk of K (:meth:`run`).  ``comm`` is the wire
    format (non-default codecs add the measured overhead to the outputs,
    ``qbits < 32`` quantizes the aggregation's input); ``robust_agg`` the
    Eq. (4) variant ("mean", "trimmed[:beta]", "clip[:factor]")."""

    selection_cfg: selection.SelectionConfig = dataclasses.field(
        default_factory=selection.SelectionConfig)
    comm: CommConfig = dataclasses.field(default_factory=CommConfig)
    robust_agg: str = "mean"

    def step(self, stacked_old, stacked_new, global_params, dropout_rates,
             weights, rng=None, *, full_round: bool,
             dense_masks: bool = False, stacked_upload=None,
             delivered=None) -> RoundOutputs:
        """Run one round's server side.

        Args:
          stacked_old / stacked_new: client params before/after local
            training, leaves (N, *leaf), contiguous, on one device.
          global_params: current global pytree (un-stacked).
          dropout_rates: (N,) D_n^t (cast to float32).
          weights: (N,) aggregation weights m_n; 0 leaves a client out of
            Eq. (4).
          rng: the round key (:mod:`repro_torch.prng`); scheme 'random'
            and ``comm.qbits == 8`` need it.
          full_round: t mod h == 0 — every client adopts the new global.
          dense_masks: all-ones masks / full uploads (FedAvg); skips the
            importance scoring.
          stacked_upload: optional stacked pytree the aggregation reads
            instead of ``stacked_new`` (the wire's corrupted rendering);
            Eq. (5) keeps ``stacked_new``.
          delivered: optional per-mask-leaf (N,) delivered-channel counts
            (int32 device tensors, or host arrays); cuts each client's
            aggregation mask to its delivered prefix.
        """
        dev = tree.leaves(stacked_new)[0].device
        return _round_step(
            stacked_old, stacked_new, global_params,
            torch.as_tensor(dropout_rates, dtype=torch.float32, device=dev),
            torch.as_tensor(weights, dtype=torch.float32, device=dev), rng,
            stacked_upload, delivered, sel_cfg=self.selection_cfg, full_round=bool(full_round),
            dense_masks=bool(dense_masks), comm=self.comm,
            robust=str(self.robust_agg))

    def run(self, state: ScanState, telemetry: ScanTelemetry, *,
            num_rounds: int, batched_train_fn: Callable, weights,
            h: int, a_server: float, d_max: float, delta: float,
            global_model_bytes: float, t_start: int = 1,
            scheme: str = "feddd", static_participants=None,
            oort_penalty=None, oort_budget: float = 0.0,
            alloc_iters: int = 96) -> Tuple[ScanState, ScanTrace]:
        """Run rounds ``t_start .. t_start + num_rounds - 1`` in full —
        training, masks, Eq. (4) aggregation, Eq. (5)/(6) updates, the
        Eq. (9)-(11) re-allocation and the Eq. (12) clock — with no host
        sync; returns the carry entering the next round and the chunk's
        :class:`ScanTrace`, both on the device.

        Each round issues the operations the per-round path issues for
        the same carry (:meth:`step`, the trainer, and the "jax"
        allocator on the same device), so K rounds here equal K per-round
        dispatches bit for bit.  Nothing a caller passed in is written.

        Args:
          state: the :class:`ScanState` entering round ``t_start``.
          telemetry: the staged :class:`ScanTelemetry`.
          num_rounds: K.
          batched_train_fn: ``(stacked_params, round_key) ->
            (stacked_params, (N,) losses)`` on the device.
          weights: (N,) aggregation weights m_n.
          h / a_server / d_max / delta / global_model_bytes: the protocol
            constants.
          scheme: "feddd" builds masks and re-allocates; "fedavg",
            "fedcs" and "oort" upload full models, non-participants
            masked back to their stale params and losses.
          static_participants: (N,) bool, required for "fedcs" (its
            selection does not depend on the losses).
          oort_penalty / oort_budget: required for "oort": the static
            ``baselines.oort_system_penalty`` and the byte budget of the
            device greedy (``baselines.select_oort_traced``).
          alloc_iters: golden-section iterations (96, as the per-round
            "jax" allocator).

        ``weights``, ``static_participants`` and ``oort_penalty`` given as
        host arrays are copied to the device here (a synchronising copy
        each); the protocol's executor stages them once a run.
        """
        if scheme == "fedcs" and static_participants is None:
            raise ValueError("scheme='fedcs' requires static_participants")
        if scheme == "oort" and oort_penalty is None:
            raise ValueError("scheme='oort' requires oort_penalty (see "
                             "baselines.oort_system_penalty) + oort_budget")
        dev = telemetry.model_bytes.device
        n = telemetry.model_bytes.shape[0]
        dense = scheme != "feddd"
        w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        everyone = torch.ones((n,), dtype=torch.bool, device=dev)
        if scheme == "fedcs":
            static_part = torch.as_tensor(static_participants,
                                          dtype=torch.bool, device=dev)
        if scheme == "oort":
            pen = torch.as_tensor(oort_penalty, dtype=torch.float32,
                                  device=dev)
            budget = torch.full((), float(oort_budget), dtype=torch.float32,
                                device=dev)
        spec = (None if self.comm.is_default else WireSpec.from_stacked(
            state.client_params, self.selection_cfg.channel_axis))
        params, gparams, losses, dropout, rng, sim_time = state
        rows = []
        for t in range(int(t_start), int(t_start) + int(num_rounds)):
            rng, rk = prng.split(rng)
            d_used = dropout
            with profiler_scope("feddd_select"):
                if scheme == "fedcs":
                    part = static_part
                elif scheme == "oort":
                    part = baselines.select_oort_traced(
                        losses, num_samples=telemetry.num_samples,
                        system_penalty=pen,
                        model_bytes=telemetry.model_bytes, budget=budget)
                else:
                    part = everyone
            with profiler_scope("feddd_local_train"):
                stacked_new, loss_dev = batched_train_fn(params, rk)
                loss_dev = torch.as_tensor(loss_dev, dtype=torch.float32)
            if dense:
                stacked_new = keep_participants(part, stacked_new, params)
                loss_dev = torch.where(part, loss_dev, losses)
            out = _round_step(
                params, stacked_new, gparams, d_used, w * part, rk,
                sel_cfg=self.selection_cfg,
                full_round=dense or t % int(h) == 0, dense_masks=dense,
                comm=self.comm, robust=str(self.robust_agg))
            with profiler_scope("feddd_allocate"):
                if dense:
                    d_next = torch.zeros_like(dropout)
                    d_time = d_next
                else:
                    d_next, _ = allocation.solve_dropout_rates_torch(
                        *telemetry, torch.clamp(loss_dev, min=1e-6),
                        a_server=a_server, d_max=d_max, delta=delta,
                        global_model_bytes=global_model_bytes,
                        num_iters=alloc_iters)
                    d_next = torch.clamp(d_next, 0.0, d_max)
                    d_time = d_used
            with profiler_scope("feddd_clock"):
                round_t = _device_round_time(telemetry, d_time, part, spec,
                                             self.comm)
                sim_time = sim_time + round_t
            params, gparams = out.client_params, out.global_params
            losses, dropout = loss_dev, d_next
            rows.append((loss_dev, out.densities, d_next, part, round_t,
                         sim_time, out.wire_overhead))
        cols = list(zip(*rows))
        trace = ScanTrace(*(torch.stack(c) for c in cols[:6]),
                          None if spec is None else torch.stack(cols[6]))
        return ScanState(params, gparams, losses, dropout, rng,
                         sim_time), trace


def _device_round_time(tel: ScanTelemetry, d_time: torch.Tensor,
                       part: torch.Tensor, spec: Optional[WireSpec],
                       comm: CommConfig) -> torch.Tensor:
    """Eq. (12) in float32 on the device: the slowest participant's
    ``t_cmp + up / r_u + U(1-D) / r_d``, the uplink leg at the codec's
    analytic bytes with a non-default wire format."""
    u_eff = tel.model_bytes * (1.0 - d_time)
    up = u_eff if spec is None else analytic_wire_bytes(spec, d_time, comm)
    t_all = (tel.compute_latency + up / tel.uplink_rate
             + u_eff / tel.downlink_rate)
    return torch.max(torch.where(part, t_all, -torch.inf))


# ------------------------------------------- client-sharded engine (mesh)

def _check_mesh(mesh) -> ClientMesh:
    """``mesh`` as a ClientMesh with a ``clients`` axis, or raise."""
    names = getattr(mesh, "axis_names", ())
    if "clients" not in names:
        raise ValueError(f"mesh must carry a 'clients' axis; got {names}")
    return mesh


def _shard_bounds(n: int, p: int) -> Tuple[int, List[Tuple[int, int]]]:
    """``(b, [(lo, hi), ...])``: shard s holds fleet rows [lo, hi) of a
    contiguous block of ``b = ceil(n / p)`` rows, zero padding taking the
    place of rows past ``n`` on the trailing shards (the JAX package's
    layout)."""
    b = -(-n // p)
    return b, [(min(s * b, n), min((s + 1) * b, n)) for s in range(p)]


def _cut_rows(t: torch.Tensor, lo: int, hi: int, rows: int,
              dev: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of ``t`` padded with zero rows up to ``rows``, on
    ``dev`` (a view where nothing pads and ``t`` is there already)."""
    part = t[lo:hi]
    if hi - lo < rows:
        part = torch.cat([part, torch.zeros((rows - (hi - lo),)
                                            + tuple(t.shape[1:]),
                                            dtype=t.dtype, device=t.device)])
    return sparse_collective.on_device(part, dev)


def _shard_tree(stacked, b: int, bounds, mesh: ClientMesh) -> List:
    """A stacked pytree as one block of ``b`` rows per shard, each on its
    shard's device."""
    return [tree.tree_map(lambda l, lo=lo, hi=hi, d=d:
                          _cut_rows(l, lo, hi, b, d), stacked)
            for (lo, hi), d in zip(bounds, mesh.devices)]


def _gather_rows(parts: Sequence[torch.Tensor], n: int,
                 dev: torch.device) -> torch.Tensor:
    """The shards' row blocks back as one (n, ...) tensor on ``dev`` (the
    one shard's block itself where nothing padded)."""
    if len(parts) == 1 and parts[0].shape[0] == n and parts[0].device == dev:
        return parts[0]
    return torch.cat([sparse_collective.on_device(x, dev) for x in parts])[:n]


def _gather_tree(parts: Sequence, n: int, dev: torch.device):
    leaves = [tree.leaves(p) for p in parts]
    treedef = tree.flatten(parts[0])[1]
    return tree.unflatten(treedef, [
        _gather_rows([lv[i] for lv in leaves], n, dev)
        for i in range(len(leaves[0]))])


def _leaf_sharded_reduce(nums: Sequence[torch.Tensor],
                         dens: Sequence[torch.Tensor], gprev, dtype, *,
                         channel_axis: int, collective: str,
                         keep_fraction: float, mesh: ClientMesh):
    """The cross-shard Eq. (4) reduction of one leaf's per-shard (num, den)
    partials -> (the aggregated leaf, () float32 overflow), both on the
    mesh's first device.

    ``collective="dense"``: the partials summed in shard order (one shard:
    the identity, no add, which makes the one-shard engine equal the
    single-device one bit for bit).  ``"sparse"``: the channel axis to the
    front, den collapsed to its (C,) channel profile (a channel mask makes
    den constant along every other axis), and
    :func:`sparse_collective.sparse_numden_allreduce` with each shard's
    nonzero-channel count as its ``k_local``: each shard ships its
    top-``K = ceil(C * keep_fraction)`` channels by den mass.
    """
    num0 = nums[0]
    ndim = num0.ndim
    ax = channel_axis % ndim if ndim else 0
    c = num0.shape[ax] if ndim else 1
    if collective == "sparse" and ndim >= 1 and c > 1:
        nums_cm = [torch.movedim(x, ax, 0) for x in nums]
        den_chs = [torch.movedim(d, ax, 0).reshape(c, -1)[:, 0]
                   for d in dens]
        k = max(1, min(c, int(math.ceil(c * keep_fraction))))
        nnz = [(d > 0).sum(dtype=torch.int32) for d in den_chs]
        num_tot, den_ch_tot, ovf = sparse_collective.sparse_numden_allreduce(
            nums_cm, den_chs, k, mesh, k_local=nnz)
        num_tot = torch.movedim(num_tot[0], 0, ax)
        dshape = [1] * ndim
        dshape[ax] = c
        den_tot = den_ch_tot[0].reshape(dshape).expand(num0.shape)
        return (aggregation.finish_masked_mean(num_tot, den_tot, gprev,
                                               dtype).contiguous(), ovf[0])
    zero = torch.zeros((), dtype=torch.float32, device=mesh.devices[0])
    return (aggregation.finish_masked_mean(
        sparse_collective.dense_sum(nums, mesh),
        sparse_collective.dense_sum(dens, mesh), gprev, dtype), zero)


def _sharded_round_step(stacked_old, stacked_new, global_params,
                        dropout_rates: torch.Tensor, weights: torch.Tensor,
                        rng, *, mesh: ClientMesh,
                        sel_cfg: selection.SelectionConfig,
                        full_round: bool, dense_masks: bool,
                        comm: CommConfig, collective: str,
                        keep_fraction: float,
                        robust: str = "mean") -> RoundOutputs:
    """:func:`_round_step` with the client axis over the shards of
    ``mesh``: shard s holds rows [s·B, (s+1)·B) (B = ceil(N / P); the
    trailing shard zero-padded with weight-0 rows).

    The shard-local phases are the calls ``_round_step`` makes — masks and
    the wire encoding with the rows' GLOBAL fleet ids (so every client's
    streams are independent of the layout), Eq. (4) partials through
    ``sparse_agg``'s partials mode (skipping masked-out terms at the 1-D
    leaves, as the JAX package's compiled sharded step does), Eq. (5)/(6)
    with the replicated global — and the one cross-shard exchange is the
    Eq. (4) reduction (:func:`_leaf_sharded_reduce`).  Non-``mean``
    ``robust`` gathers every shard's rows onto the first device and runs
    the single-device robust reduction there, as the JAX package's
    all-gather fallback.  Outputs land on the first device, in fleet
    order."""
    n = tree.leaves(stacked_new)[0].shape[0]
    dev0 = mesh.devices[0]
    b, bounds = _shard_bounds(n, mesh.num_shards)
    olds = _shard_tree(stacked_old, b, bounds, mesh)
    news = _shard_tree(stacked_new, b, bounds, mesh)
    ds = [_cut_rows(dropout_rates, lo, hi, b, dv)
          for (lo, hi), dv in zip(bounds, mesh.devices)]
    ws = [_cut_rows(weights, lo, hi, b, dv)
          for (lo, hi), dv in zip(bounds, mesh.devices)]
    ids = [np.arange(s * b, (s + 1) * b) for s in range(mesh.num_shards)]
    r_kind, r_arg = aggregation.parse_robust_agg(robust)
    masks, dens, aggs, ohs = [], [], [], []
    with profiler_scope("feddd_encode_masks"):
        for o, nw, dd, i in zip(olds, news, ds, ids):
            if dense_masks:
                m, de = _dense_masks(nw, b)
            else:
                m, de = selection.build_masks_batched(
                    o, nw, dd, config=sel_cfg, rng=rng, client_indices=i)
            masks.append(m)
            dens.append(de)
    with profiler_scope("feddd_encode_wire"):
        for nw, m, i in zip(news, masks, ids):
            aggs.append(wire_quant.quantize_dequantize_stacked(
                nw, rng, comm.qbits, client_indices=i))
            ohs.append(_wire_overhead(m, nw, comm, sel_cfg.channel_axis,
                                      dense_masks))
    with profiler_scope("feddd_aggregate"):
        g_leaves, treedef = tree.flatten(global_params)
        overflow = torch.zeros((), dtype=torch.float32, device=dev0)
        if r_kind != "mean":
            sw_full = [_gather_rows(list(ls), b * len(ls), dev0)
                       for ls in zip(*[tree.leaves(a) for a in aggs])]
            sm_full = [_gather_rows(list(ls), b * len(ls), dev0)
                       for ls in zip(*[tree.leaves(m) for m in masks])]
            out_leaves = aggregation.robust_leaf_stacks(
                sw_full, sm_full, _gather_rows(ws, b * len(ws), dev0),
                g_leaves, r_kind, r_arg)
        else:
            out_leaves = []
            a_leaves = [tree.leaves(a) for a in aggs]
            m_leaves = [tree.leaves(m) for m in masks]
            for li, gl in enumerate(g_leaves):
                nums, dns = [], []
                for s in range(mesh.num_shards):
                    sw = a_leaves[s][li]
                    num, den = aggregation.leaf_masked_partials(
                        sw, m_leaves[s][li], ws[s],
                        select=aggregation.select_leaf(sw, True))
                    nums.append(num)
                    dns.append(den)
                agg, ovf = _leaf_sharded_reduce(
                    nums, dns, gl, a_leaves[0][li].dtype,
                    channel_axis=sel_cfg.channel_axis,
                    collective=collective, keep_fraction=keep_fraction,
                    mesh=mesh)
                overflow = overflow + ovf
                out_leaves.append(agg)
        new_global = tree.unflatten(treedef, out_leaves)
    with profiler_scope("feddd_client_update"):
        clients = []
        for nw, m, dv in zip(news, masks, mesh.devices):
            g_s = tree.tree_map(lambda g: sparse_collective.on_device(g, dv),
                                new_global)
            clients.append(_adopt_global(g_s, nw) if full_round else
                           aggregation.client_update_sparse(g_s, nw, m))
    return RoundOutputs(
        _gather_tree(clients, n, dev0), new_global,
        _gather_rows(dens, n, dev0),
        None if comm.is_default else _gather_rows(ohs, n, dev0), overflow)


@dataclasses.dataclass
class ShardedRoundEngine:
    """Client-sharded FedDD rounds over a 1-D ``clients`` mesh
    (:class:`~repro_torch.launch.mesh.ClientMesh`).

    Each shard's rows run the shard-local phases of a round (masks, wire
    encoding, Eq. (4) partials, Eq. (5)/(6)) on its device; the one
    cross-shard exchange is the Eq. (4) (num, den) reduction — the dense
    sum by default, or the compacted top-K channel exchange of
    :mod:`~repro_torch.core.sparse_collective` (``collective="sparse"``),
    whose bytes scale with (1-D).  One process drives every shard, as the
    JAX package's ``shard_map`` does; a mesh that repeats one device
    (virtual shards) runs the whole multi-shard step on it with no copy
    between shards.

    Contracts (``tests/test_torch_sharded.py``): on one shard with the
    dense collective a step equals :class:`BatchedRoundEngine`'s bit for
    bit; on several it is within 2e-6 (the partial sums add in another
    order) with equal densities; ``collective_overflow`` counts the
    channels that missed a shard's buffer (0: lossless).  Clients need
    not divide the mesh: the trailing shard pads with weight-0 rows.
    """

    selection_cfg: selection.SelectionConfig = dataclasses.field(
        default_factory=selection.SelectionConfig)
    comm: CommConfig = dataclasses.field(default_factory=CommConfig)
    mesh: Optional[ClientMesh] = None
    collective: str = "dense"      # dense sum | sparse compacted top-K
    keep_fraction: float = 1.0     # sparse buffer: K = ceil(C * fraction)
    robust_agg: str = "mean"       # non-mean gathers every shard's rows

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError("ShardedRoundEngine requires a mesh (see "
                             "repro_torch.launch.mesh.make_client_mesh)")
        _check_mesh(self.mesh)
        if self.collective not in ("dense", "sparse"):
            raise ValueError(f"collective must be 'dense' or 'sparse', "
                             f"got {self.collective!r}")
        if not 0.0 < self.keep_fraction <= 1.0:
            raise ValueError(f"keep_fraction must be in (0,1], got "
                             f"{self.keep_fraction}")
        aggregation.parse_robust_agg(self.robust_agg)

    @property
    def num_shards(self) -> int:
        return self.mesh.num_shards

    def step(self, stacked_old, stacked_new, global_params, dropout_rates,
             weights, rng=None, *, full_round: bool,
             dense_masks: bool = False, stacked_upload=None,
             delivered=None) -> RoundOutputs:
        """One sharded round; the arguments and outputs of
        :meth:`BatchedRoundEngine.step` (the outputs on the mesh's first
        device), plus ``collective_overflow``.  Upload overrides and
        delivered prefixes are single-device features and raise."""
        if stacked_upload is not None or delivered is not None:
            raise NotImplementedError(
                "upload overrides / delivered prefixes are single-device "
                "engine features (fault corruption and deadline partial "
                "aggregation do not shard)")
        dev = tree.leaves(stacked_new)[0].device
        return _sharded_round_step(
            stacked_old, stacked_new, global_params,
            torch.as_tensor(dropout_rates, dtype=torch.float32, device=dev),
            torch.as_tensor(weights, dtype=torch.float32, device=dev), rng,
            mesh=self.mesh, sel_cfg=self.selection_cfg,
            full_round=bool(full_round), dense_masks=bool(dense_masks),
            comm=self.comm, collective=self.collective,
            keep_fraction=float(self.keep_fraction),
            robust=str(self.robust_agg))


# --------------------------------------------------- shape-grouped engine

def _slice_leaf(g: torch.Tensor, local_shape) -> torch.Tensor:
    """HeteroFL width slicing: the leading [0:s) block of every axis, made
    contiguous (the merge kernel reads contiguous leaves; a copy of at
    most the global leaf's bytes)."""
    if tuple(g.shape) == tuple(local_shape):
        return g
    return g[tuple(slice(0, s) for s in local_shape)].contiguous()


def slice_pytree(global_params, local_template):
    """A full-width pytree sliced down to a sub-model's local widths."""
    return tree.tree_map(lambda g, l: _slice_leaf(g, l.shape),
                         global_params, local_template)


def _grouped_round_step(groups: Sequence[GroupBatch], global_params,
                        weights: torch.Tensor, rng, *,
                        sel_cfg: selection.SelectionConfig,
                        full_round: bool, dense_masks: bool = False,
                        comm: CommConfig = CommConfig(),
                        robust: str = "mean") -> GroupedRoundOutputs:
    """Steps 2-4 and 6-7 of Algorithm 1 over a shape-grouped fleet: per
    group, coverage-aware masks at its own widths (the importance
    kernel's split planned per client, so each member's scores are the
    per-client loop's, and the densities divided as the loop divides)
    and the decoded uploads with member-keyed quantization; Eq. (4) on the full-width canvas; Eq. (5)/(6) per group
    at local widths against the sliced global.  ``weights`` is the (N,)
    float32 device vector of m_n by canvas row.  Profiler scopes as
    :func:`_round_step`'s."""
    n = weights.shape[0]
    dev = weights.device
    rows = [g.rows if g.rows is not None else torch.as_tensor(
        g.indices, dtype=torch.long, device=dev) for g in groups]
    densities = torch.zeros((n,), dtype=torch.float32, device=dev)
    group_masks = []
    with profiler_scope("feddd_encode_masks"):
        for g, r in zip(groups, rows):
            if dense_masks:
                masks, dens = _dense_masks(g.stacked_new, len(g.indices))
            else:
                masks, dens = selection.build_masks_batched(
                    g.stacked_old, g.stacked_new, g.dropout, config=sel_cfg,
                    rng=rng, coverage=g.coverage, client_indices=g.indices,
                    match_loop=True)
            group_masks.append(masks)
            densities.index_copy_(0, r, dens)
    # the server aggregates what it decoded; member keys fold the fleet
    # positions, as the per-client loop's
    with profiler_scope("feddd_encode_wire"):
        group_agg = [wire_quant.quantize_dequantize_stacked(
            g.stacked_new, rng, comm.qbits, client_indices=g.indices)
            for g in groups]
        wire_oh = None
        if not comm.is_default:
            wire_oh = torch.zeros((n,), dtype=torch.int32, device=dev)
            for g, r, masks in zip(groups, rows, group_masks):
                wire_oh.index_copy_(0, r, _wire_overhead(
                    masks, g.stacked_new, comm, sel_cfg.channel_axis,
                    dense_masks))
    with profiler_scope("feddd_aggregate"):
        new_global = aggregation.aggregate_sparse_grouped(
            group_agg, group_masks, rows, weights, global_params,
            prev_global=global_params, robust=robust)
    with profiler_scope("feddd_client_update"):
        new_group_params = []
        for g, masks in zip(groups, group_masks):
            g_local = slice_pytree(new_global,
                                   unstack_pytree(g.stacked_new, 1)[0])
            if full_round:       # Eq. (6): every member adopts its slice
                new_group_params.append(_adopt_global(g_local,
                                                      g.stacked_new))
            else:                # Eq. (5) at local widths
                new_group_params.append(aggregation.client_update_sparse(
                    g_local, g.stacked_new, masks))
    return GroupedRoundOutputs(tuple(new_group_params), new_global,
                               densities, wire_oh)


def _sharded_grouped_round_step(groups: Sequence[GroupBatch], global_params,
                                weights: torch.Tensor, rng, *,
                                mesh: ClientMesh,
                                sel_cfg: selection.SelectionConfig,
                                full_round: bool, dense_masks: bool = False,
                                comm: CommConfig = CommConfig()
                                ) -> GroupedRoundOutputs:
    """:func:`_grouped_round_step` with every group's MEMBER axis over the
    shards of ``mesh`` (each group laid out as :func:`_sharded_round_step`
    lays out the fleet, its padded rows at weight 0 with the id N).

    Per group and shard: the coverage-aware masks at the group's widths
    (planned and divided as the unsharded grouped step's, so the
    densities are its own), the decoded uploads, and the Eq. (4) partials
    at local widths through ``sparse_agg``'s partials mode with the
    channel mask (skipping masked-out terms at the 1-D leaves, as the JAX
    package's compiled sharded grouped step does), zero-padded to the
    global widths.  The partials sum across shards, then across groups
    (Eq. (4)'s sums are linear), before one shared
    ``finish_masked_mean``; Eq. (5)/(6) per group and shard at local
    widths.  Allclose to the unsharded step, which reduces every row in
    one canvas in another order."""
    n = weights.shape[0]
    dev0 = mesh.devices[0]
    g_leaves, treedef = tree.flatten(global_params)
    num_tot = [torch.zeros(gl.shape, dtype=torch.float32, device=dev0)
               for gl in g_leaves]
    den_tot = [torch.zeros(gl.shape, dtype=torch.float32, device=dev0)
               for gl in g_leaves]
    densities = torch.zeros((n,), dtype=torch.float32, device=dev0)
    wire_oh = (None if comm.is_default else
               torch.zeros((n,), dtype=torch.int32, device=dev0))
    staged = []
    for g in groups:
        n_g = len(g.indices)
        rows = g.rows if g.rows is not None else torch.as_tensor(
            g.indices, dtype=torch.long, device=weights.device)
        b, bounds = _shard_bounds(n_g, mesh.num_shards)
        w_rows = weights.index_select(0, rows)
        ids = np.concatenate([np.asarray(g.indices, np.int64),
                              np.full(b * mesh.num_shards - n_g, n,
                                      np.int64)])
        olds = _shard_tree(g.stacked_old, b, bounds, mesh)
        news = _shard_tree(g.stacked_new, b, bounds, mesh)
        masks, dens, ohs = [], [], []
        parts = [[] for _ in g_leaves]
        for s, ((lo, hi), dv) in enumerate(zip(bounds, mesh.devices)):
            sl = slice(s * b, (s + 1) * b)
            ws = _cut_rows(w_rows, lo, hi, b, dv)
            with profiler_scope("feddd_encode_masks"):
                if dense_masks:
                    m, de = _dense_masks(news[s], b)
                else:
                    cov = (None if g.coverage is None else tree.tree_map(
                        lambda c: sparse_collective.on_device(c, dv), g.coverage))
                    m, de = selection.build_masks_batched(
                        olds[s], news[s],
                        _cut_rows(g.dropout, lo, hi, b, dv),
                        config=sel_cfg, rng=rng, coverage=cov,
                        client_indices=ids[sl], match_loop=True)
            with profiler_scope("feddd_encode_wire"):
                agg = wire_quant.quantize_dequantize_stacked(
                    news[s], rng, comm.qbits, client_indices=ids[sl])
                ohs.append(_wire_overhead(m, news[s], comm,
                                          sel_cfg.channel_axis, dense_masks))
            masks.append(m)
            dens.append(de)
            with profiler_scope("feddd_aggregate"):
                for li, (sw, sm, gl) in enumerate(zip(
                        tree.leaves(agg), tree.leaves(m), g_leaves)):
                    num, den = aggregation.leaf_masked_partials(
                        sw, sm, ws, select=aggregation.select_leaf(sw, True))
                    parts[li].append((aggregation.pad_to(num, gl.shape),
                                      aggregation.pad_to(den, gl.shape)))
        with profiler_scope("feddd_aggregate"):
            for li, pl in enumerate(parts):
                num_tot[li] = num_tot[li] + sparse_collective.dense_sum(
                    [x for x, _ in pl], mesh)
                den_tot[li] = den_tot[li] + sparse_collective.dense_sum(
                    [y for _, y in pl], mesh)
        densities.index_copy_(0, rows, _gather_rows(dens, n_g, dev0))
        if wire_oh is not None:
            wire_oh.index_copy_(0, rows, _gather_rows(ohs, n_g, dev0))
        staged.append((g, news, masks, n_g))
    with profiler_scope("feddd_aggregate"):
        new_global = tree.unflatten(treedef, [
            aggregation.finish_masked_mean(num, den, gl, gl.dtype)
            for num, den, gl in zip(num_tot, den_tot, g_leaves)])
    with profiler_scope("feddd_client_update"):
        new_group_params = []
        for g, news, masks, n_g in staged:
            template = unstack_pytree(g.stacked_new, 1)[0]
            outs = []
            for nw, m, dv in zip(news, masks, mesh.devices):
                g_local = tree.tree_map(
                    lambda x: sparse_collective.on_device(x, dv),
                    slice_pytree(new_global, template))
                outs.append(_adopt_global(g_local, nw) if full_round else
                            aggregation.client_update_sparse(g_local, nw, m))
            new_group_params.append(_gather_tree(outs, n_g, dev0))
    return GroupedRoundOutputs(tuple(new_group_params), new_global,
                               densities, wire_oh)


@dataclasses.dataclass
class GroupedRoundEngine:
    """FedDD rounds over a shape-grouped ragged fleet — the heterogeneous
    counterpart of :class:`BatchedRoundEngine`.  With ``mesh`` (a
    :class:`~repro_torch.launch.mesh.ClientMesh`) each group's member axis
    shards over it (:func:`_sharded_grouped_round_step`): allclose to the
    unsharded step, densities equal; ``robust_agg`` other than "mean"
    does not compose with per-shard partials and raises there."""

    selection_cfg: selection.SelectionConfig = dataclasses.field(
        default_factory=selection.SelectionConfig)
    comm: CommConfig = dataclasses.field(default_factory=CommConfig)
    mesh: Optional[ClientMesh] = None
    robust_agg: str = "mean"

    def __post_init__(self):
        aggregation.parse_robust_agg(self.robust_agg)
        if self.mesh is not None:
            _check_mesh(self.mesh)
            if str(self.robust_agg) != "mean":
                raise NotImplementedError(
                    "robust_agg is a single-device grouped-engine feature: "
                    "the sharded grouped step sums per-group (num, den) "
                    "partials across shards, which trimmed/clip "
                    "aggregation cannot compose with")

    def step(self, groups: Sequence[GroupBatch], global_params, weights,
             rng, *, full_round: bool,
             dense_masks: bool = False) -> GroupedRoundOutputs:
        """Run one round's server side over the grouped fleet.

        Args:
          groups: one :class:`GroupBatch` per shape group; its ``indices``
            are rows of ``weights`` and of the density canvas and the ids
            the members' keys fold in.
          global_params: the current full-width global pytree.
          weights: (N,) aggregation weights m_n by canvas row (0 leaves
            a row out); a float32 tensor on the device is used as it is,
            anything else is copied there (a synchronising copy).
          rng: the round key (scheme 'random', int8 rounding).
          full_round / dense_masks: as :meth:`BatchedRoundEngine.step`.
        """
        dev = tree.leaves(global_params)[0].device
        w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        if self.mesh is not None:
            return _sharded_grouped_round_step(
                tuple(groups), global_params, w, rng, mesh=self.mesh,
                sel_cfg=self.selection_cfg, full_round=bool(full_round),
                dense_masks=bool(dense_masks), comm=self.comm)
        return _grouped_round_step(
            tuple(groups), global_params, w, rng,
            sel_cfg=self.selection_cfg, full_round=bool(full_round),
            dense_masks=bool(dense_masks), comm=self.comm,
            robust=str(self.robust_agg))


def train_grouped(groups, group_stacked, group_coverage, local_train_fn,
                  rk, part, losses, d_used, *, dense: bool,
                  num_clients: int, group_rows=None):
    """Local training over the grouped state and the :class:`GroupBatch`
    of each group: member ``i`` trains under ``fold_in(rk, i)`` iff
    ``part[i]`` (all of them for feddd); a non-participant keeps its stale
    params and loss.  Returns ``(losses, batches)``: the per-client losses
    in fleet order and one batch per group (``group_rows``: each group's
    staged device rows)."""
    loss_out: List = [None] * num_clients
    batches: List[GroupBatch] = []
    rows = group_rows or [None] * len(groups)
    for grp, stacked, cov, r in zip(groups, group_stacked, group_coverage,
                                    rows):
        per_client = unstack_pytree(stacked, grp.size)
        new_list = []
        for pos, i in enumerate(grp.indices):
            if part[i]:
                p, l = local_train_fn(per_client[pos], i,
                                      prng.fold_in(rk, i))
            else:
                p, l = per_client[pos], losses[i]
            new_list.append(p)
            loss_out[i] = l
        dev = tree.leaves(stacked)[0].device
        batches.append(GroupBatch(
            indices=np.asarray(grp.indices, np.int64),
            stacked_old=stacked, stacked_new=stack_pytrees(new_list),
            coverage=None if dense else cov,
            dropout=torch.as_tensor(
                np.asarray(d_used, np.float32)[list(grp.indices)],
                device=dev),
            rows=r))
    return loss_out, batches


def unstack_groups(groups, group_stacked, num_clients: int) -> List:
    """Grouped stacked state -> per-client pytrees in fleet order."""
    params: List = [None] * num_clients
    for grp, stacked in zip(groups, group_stacked):
        for i, p in zip(grp.indices, unstack_pytree(stacked, grp.size)):
            params[i] = p
    return params


class GroupedFleetState:
    """A ragged fleet's state between grouped rounds: each group's stacked
    params (kept stacked across rounds), its coverage and its device rows,
    and the train -> step -> export cycle."""

    def __init__(self, groups, group_coverage, client_params,
                 selection_cfg: selection.SelectionConfig,
                 num_clients: int, comm: CommConfig = CommConfig(),
                 mesh=None, robust_agg: str = "mean"):
        self.engine = GroupedRoundEngine(selection_cfg, comm, mesh,
                                         robust_agg)
        self.groups = groups
        self.coverage = group_coverage
        self.num_clients = num_clients
        self.group_stacked = [
            stack_pytrees([client_params[i] for i in g.indices])
            for g in groups]
        self.rows = [torch.as_tensor(
            g.indices, dtype=torch.long,
            device=tree.leaves(stacked)[0].device)
            for g, stacked in zip(groups, self.group_stacked)]
        self._batches = None

    def train(self, local_train_fn, rk, part, losses, d_used, *,
              dense: bool) -> List:
        """Local training and this round's batches; returns the
        per-client losses in fleet order."""
        losses, self._batches = train_grouped(
            self.groups, self.group_stacked, self.coverage, local_train_fn,
            rk, part, losses, d_used, dense=dense,
            num_clients=self.num_clients, group_rows=self.rows)
        return losses

    def step(self, global_params, weights, rk, *, full_round: bool,
             dense: bool):
        """One grouped step over the staged batches -> (new global,
        densities, wire overhead or None); rebinds the stacked state."""
        out = self.engine.step(self._batches, global_params, weights, rk,
                               full_round=full_round, dense_masks=dense)
        self.group_stacked = list(out.group_client_params)
        return out.global_params, out.densities, out.wire_overhead

    def discard(self) -> None:
        """Drop a staged round without a step: client params stay as they
        were before training (a quorum-skipped round of the fault layer)."""
        self._batches = None

    @property
    def staged_batches(self):
        """The batches ``train`` staged for the next ``step``."""
        return self._batches

    def export(self) -> List:
        """Per-client pytrees in fleet order (views of the stacks)."""
        return unstack_groups(self.groups, self.group_stacked,
                              self.num_clients)


def make_batched_train_fn(per_client_step: Callable,
                          stacked_data: Sequence[torch.Tensor]) -> Callable:
    """``torch.func.vmap`` a per-client ``step(params, *client_data) ->
    (params, loss)`` into ``(stacked_params, rng) -> (stacked_params, (N,)
    losses)`` — a fused trainer for fleets whose data shards share one
    shape (``stacked_data``: tensors with a leading client axis).  The
    key is dropped, as in the JAX package.  A vmapped row can differ from
    the same step run alone in the last bits (the batched GEMM orders
    its sums differently).  float32 stays float32 on the card: TF32 is
    switched off for matmuls and cuDNN convolutions and cuDNN runs its
    deterministic algorithms, process-wide, as the per-client trainer
    (``fl.models.make_local_train_fn``) does.  The convolutions of
    ``fl.models.apply_spec`` under this vmap take the client-batched
    kernels on a card (``kernels.conv``: one launch a pass for the
    fleet, in float32 FFMA and a fixed order) and the vmapped
    ``F.conv2d`` elsewhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    vstep = torch.func.vmap(per_client_step)

    def batched(stacked_params, rng):
        del rng
        return vstep(stacked_params, *stacked_data)

    return batched
