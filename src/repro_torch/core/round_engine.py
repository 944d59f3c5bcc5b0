"""Batched FedDD round engine — the homogeneous hot path on the card.

Client parameter pytrees stack along a leading client axis, and one call
runs the server side of a round over the whole fleet:

    importance scoring   — importance kernel, one launch per leaf
    mask building        — a stable descending sort per client row and a
                           ``rank < keep`` compare
    masked aggregation   — Eq. (4), sparse_agg kernel, one launch per leaf
    client update        — Eq. (5), masked_merge kernel, one launch for
                           every leaf (or Eq. (6) on full rounds)

The per-round device-to-host traffic is the (N,) density vector.

The engine also serves the FedAvg baseline (``dense_masks``: all-ones
masks, no scoring); non-participation is a 0 aggregation weight.  Wire
codecs, fault injection (``stacked_upload`` / ``delivered``), robust
aggregation and the scanned multi-round path of the JAX engine are not
ported yet (ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import torch

from repro_torch import tree
from repro_torch.core import aggregation, selection


class RoundOutputs(NamedTuple):
    """Results of one batched round step, on the parameters' device."""

    client_params: object      # pytree, leaves (N, *leaf): W_n^{t+1}
    global_params: object      # pytree: W^t
    densities: torch.Tensor    # (N,) fraction of elements uploaded


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


def _round_step(stacked_old, stacked_new, global_params, dropout_rates,
                weights, *, sel_cfg: selection.SelectionConfig,
                full_round: bool, dense_masks: bool = False
                ) -> RoundOutputs:
    """Steps 2-4 and 6-7 of Algorithm 1 over the stacked fleet."""
    if dense_masks:
        n = tree.leaves(stacked_new)[0].shape[0]
        masks, density = _dense_masks(stacked_new, n)
    else:
        masks, density = selection.build_masks_batched(
            stacked_old, stacked_new, dropout_rates, config=sel_cfg)
    new_global = aggregation.aggregate_sparse_stacked(
        stacked_new, masks, weights, prev_global=global_params)
    if full_round:
        new_clients = _adopt_global(new_global, stacked_new)
    else:
        new_clients = aggregation.client_update_sparse(
            new_global, stacked_new, masks)
    return RoundOutputs(new_clients, new_global, density)


@dataclasses.dataclass
class BatchedRoundEngine:
    """One FedDD round over client-stacked parameters."""

    selection_cfg: selection.SelectionConfig = dataclasses.field(
        default_factory=selection.SelectionConfig)

    def step(self, stacked_old, stacked_new, global_params, dropout_rates,
             weights, *, full_round: bool,
             dense_masks: bool = False) -> RoundOutputs:
        """Run one round's server side.

        Args:
          stacked_old / stacked_new: client params before/after local
            training, leaves (N, *leaf), contiguous, on one device.
          global_params: current global pytree (un-stacked).
          dropout_rates: (N,) D_n^t (cast to float32).
          weights: (N,) aggregation weights m_n; 0 leaves a client out of
            Eq. (4).
          full_round: t mod h == 0 — every client adopts the new global.
          dense_masks: all-ones masks / full uploads (FedAvg); skips the
            importance scoring.
        """
        dev = tree.leaves(stacked_new)[0].device
        return _round_step(
            stacked_old, stacked_new, global_params,
            torch.as_tensor(dropout_rates, dtype=torch.float32, device=dev),
            torch.as_tensor(weights, dtype=torch.float32, device=dev),
            sel_cfg=self.selection_cfg, full_round=bool(full_round),
            dense_masks=bool(dense_masks))
