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

The engine also serves the FedAvg baseline (``dense_masks``: all-ones
masks, no scoring); non-participation is a 0 aggregation weight.  Fault
injection (``stacked_upload`` / ``delivered``), robust aggregation and
the scanned multi-round path of the JAX engine are not ported yet
(ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch import tree
from repro_torch.comm import codecs as wire_codecs
from repro_torch.comm import quantize as wire_quant
from repro_torch.comm.payload import CommConfig, WireSpec
from repro_torch.core import aggregation, selection
from repro_torch.obs.recorder import profiler_scope


class RoundOutputs(NamedTuple):
    """Results of one batched round step, on the parameters' device."""

    client_params: object      # pytree, leaves (N, *leaf): W_n^{t+1}
    global_params: object      # pytree: W^t
    densities: torch.Tensor    # (N,) fraction of elements uploaded
    wire_overhead: Optional[torch.Tensor] = None
                               # (N,) int32 measured mask/scale bytes;
                               # None with the default CommConfig


def stack_pytrees(trees: Sequence) -> object:
    """[pytree] x N (identical structure/shapes) -> pytree of (N, *leaf)."""
    return tree.tree_map(lambda *ls: torch.stack(ls), *trees)


def unstack_pytree(stacked, n: int) -> List:
    """Inverse of :func:`stack_pytrees` (views, no copies)."""
    return [tree.tree_map(lambda l: l[i], stacked) for i in range(n)]


def _adopt_global(new_global, stacked):
    """Eq. (6): every client adopts the fresh global model (materialised,
    so the next round's kernels read contiguous client stacks)."""
    return tree.tree_map(
        lambda g, l: g.to(l.dtype).expand(l.shape).contiguous(),
        new_global, stacked)


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
                weights, rng, *, sel_cfg: selection.SelectionConfig,
                full_round: bool, dense_masks: bool = False,
                comm: CommConfig = CommConfig()) -> RoundOutputs:
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
    # the server aggregates what it decoded; Eq. (5) below keeps the
    # clients' own full-precision values
    with profiler_scope("feddd_encode_wire"):
        stacked_agg = wire_quant.quantize_dequantize_stacked(
            stacked_new, rng, comm.qbits)
        wire_oh = _wire_overhead(masks, stacked_new, comm,
                                 sel_cfg.channel_axis, dense_masks)
    with profiler_scope("feddd_aggregate"):
        new_global = aggregation.aggregate_sparse_stacked(
            stacked_agg, masks, weights, prev_global=global_params)
    with profiler_scope("feddd_client_update"):
        if full_round:
            new_clients = _adopt_global(new_global, stacked_new)
        else:
            new_clients = aggregation.client_update_sparse(
                new_global, stacked_new, masks)
    return RoundOutputs(new_clients, new_global, density, wire_oh)


@dataclasses.dataclass
class BatchedRoundEngine:
    """One FedDD round over client-stacked parameters; ``comm`` is the
    wire format (non-default codecs add the measured overhead to the
    outputs, ``qbits < 32`` quantizes the aggregation's input)."""

    selection_cfg: selection.SelectionConfig = dataclasses.field(
        default_factory=selection.SelectionConfig)
    comm: CommConfig = dataclasses.field(default_factory=CommConfig)

    def step(self, stacked_old, stacked_new, global_params, dropout_rates,
             weights, rng=None, *, full_round: bool,
             dense_masks: bool = False) -> RoundOutputs:
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
        """
        dev = tree.leaves(stacked_new)[0].device
        return _round_step(
            stacked_old, stacked_new, global_params,
            torch.as_tensor(dropout_rates, dtype=torch.float32, device=dev),
            torch.as_tensor(weights, dtype=torch.float32, device=dev), rng,
            sel_cfg=self.selection_cfg, full_round=bool(full_round),
            dense_masks=bool(dense_masks), comm=self.comm)
