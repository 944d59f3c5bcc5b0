"""Mixture-of-Experts feed-forward with top-k token-choice routing.

The counterpart of ``repro.models.moe``, with its sort-based capacity
dispatch:

  1. router logits -> top-k expert ids and renormalised probabilities per
     token (ties to the lower expert id, as ``lax.top_k``: a stable
     descending sort, never ``torch.topk``);
  2. each assignment's position in its expert by a stable sort over the
     expert ids (no (T, E) one-hot); an assignment past the expert's
     capacity is dropped;
  3. the kept tokens copied into a static (E, capacity, d) buffer, one
     batched matmul per projection, gathered back and combined with the
     routing probabilities.

The combine sums a token's k rows in rank order through a (T, k, d)
view, with no atomic add, so two runs on the card are bit-equal; the
dispatch copies each kept row to its own slot (an ``index_copy``), the
dropped ones to a scratch row that is discarded.  The load-balance loss
is the Switch one, ``E * sum(mean prob per expert * fraction of
assignments per expert)``, times ``router_aux_loss``.

The JAX package also blocks the dispatch by data shard and has an
expert-parallel ``shard_map`` path for a mesh with a ``model`` axis; on
one card it takes neither (one block, no mesh), and neither is ported.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models import layers, mlp
from repro_torch.models.config import MoEConfig


def init_moe(gen: torch.Generator, d_model: int, mcfg: MoEConfig,
             activation: str, dtype, lead=()) -> dict:
    e, f = mcfg.num_experts, mcfg.d_ff_expert
    lead = tuple(lead)
    p = {
        "router": layers.init_dense(gen, d_model, e, torch.float32,
                                    lead=lead)["kernel"],
        "w_up": layers.normal(gen, lead + (e, d_model, f),
                              1.0 / math.sqrt(d_model), dtype),
        "w_down": layers.normal(gen, lead + (e, f, d_model),
                                1.0 / math.sqrt(f), dtype),
    }
    if activation in mlp.GATED:
        p["w_gate"] = layers.normal(gen, lead + (e, d_model, f),
                                    1.0 / math.sqrt(d_model), dtype)
    return p


def _capacity(num_tokens: int, mcfg: MoEConfig) -> int:
    """Slots per expert, padded to a multiple of 8 (at least 8)."""
    cap = int(num_tokens * mcfg.top_k * mcfg.capacity_factor
              / mcfg.num_experts)
    return max(8, (cap + 7) // 8 * 8)


def route(p, x_flat: torch.Tensor, mcfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (expert_ids (T, k) int64, probs (T, k) in x's dtype,
    aux_loss 0-d fp32)."""
    logits = torch.matmul(x_flat.float(), p["router"])
    probs_full = torch.softmax(logits, dim=-1)
    top_ids = torch.sort(probs_full, dim=-1, descending=True,
                         stable=True).indices[:, :mcfg.top_k]
    top_p = torch.gather(probs_full, 1, top_ids)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    e = mcfg.num_experts
    me = probs_full.mean(dim=0)                                # (E,)
    flat = top_ids.reshape(-1)
    ce = torch.zeros(e, dtype=torch.float32, device=x_flat.device)
    ce = ce.index_add(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                          device=x_flat.device))
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    aux = (me * ce).sum() * e
    return top_ids, top_p.to(x_flat.dtype), aux


def _positions_in_expert(flat_ids: torch.Tensor, e: int, cap: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each assignment's rank within its expert's run (stable: in token
    order), clamped to ``cap - 1``, and whether it fits (rank < cap)."""
    n = flat_ids.shape[0]
    dev = flat_ids.device
    order = torch.sort(flat_ids, stable=True).indices
    sorted_ids = flat_ids[order]
    # bincount as an index_add_ (exact for integers; bincount has no meta
    # kernel, and the dry-run traces this on meta tensors)
    counts = torch.zeros(e, dtype=torch.int64, device=dev).index_add_(
        0, flat_ids, torch.ones_like(flat_ids, dtype=torch.int64))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=dev) - starts[sorted_ids]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    return torch.where(keep, pos, cap - 1), keep


def apply_moe(p, x: torch.Tensor, mcfg: MoEConfig, activation: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss * router_aux_loss).

    The JAX package's ``_apply_moe_gspmd`` with one dispatch block (its
    block count is the mesh's data-shard count, 1 off a mesh)."""
    b, s, d = x.shape
    t = b * s
    dt = x.dtype
    xf = x.reshape(t, d)
    ids, probs, aux = route(p, xf, mcfg)
    k, e = mcfg.top_k, mcfg.num_experts
    cap = _capacity(t, mcfg)
    dev = x.device

    flat_ids = ids.reshape(-1)
    token_idx = torch.arange(t, device=dev).repeat_interleave(k)
    pos, keep = _positions_in_expert(flat_ids, e, cap)
    slot = torch.where(keep, flat_ids * cap + pos, e * cap)   # e*cap: dropped
    buf = torch.zeros((e * cap + 1, d), dtype=dt, device=dev).index_copy(
        0, slot, xf[token_idx])[:e * cap].view(e, cap, d)

    up = torch.bmm(buf, p["w_up"].to(dt))
    if activation in mlp.GATED:
        gate = torch.bmm(buf, p["w_gate"].to(dt))
        h = mlp._act(activation, gate) * up
    else:
        h = mlp._act(activation, up)
    out_buf = torch.bmm(h, p["w_down"].to(dt)).reshape(e * cap, d)

    gathered = out_buf[flat_ids * cap + pos]                  # (t*k, d)
    gathered = torch.where(keep[:, None], gathered, 0.0)
    weighted = (gathered * probs.reshape(-1)[:, None]).view(t, k, d)
    y = weighted[:, 0]
    for j in range(1, k):
        y = y + weighted[:, j]
    return y.reshape(b, s, d), aux * mcfg.router_aux_loss
