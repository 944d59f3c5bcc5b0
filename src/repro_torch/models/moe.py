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

On a mesh (``apply_moe_mesh``, an ``LMMesh`` with the experts over
``model``) the two paths of the JAX package compute something other than
one block, and both are ported:

  * blocked dispatch (``_apply_moe_gspmd``): the tokens are cut into
    one block per ``("pod", "data")`` shard, halved until every block
    has at least 256 tokens (:func:`n_blocks`), and each block has its
    own capacity ``_capacity(t / n)``, so the blocking changes which
    assignments are dropped; each device dispatches the blocks it holds,
    runs its own experts, gathers the other experts' outputs of its
    blocks from its row and combines in the model's dtype.
    :func:`apply_moe` takes ``n_blocks`` for the same dispatch on one
    device;
  * expert parallelism (``_apply_moe_ep``, where ``model > 1`` divides
    the experts and every data shard's block has at least 64 tokens):
    each device ranks only the assignments of its own experts (a
    sentinel bucket for the rest), combines them in fp32 and the partials
    are summed over ``model`` (in model order, on the row's first
    device) before the cast to the model's dtype.

Decode batches take neither threshold and stay one block.
:func:`dispatch_counts` counts the MoE layers by the path they took.
"""

from __future__ import annotations

import collections
import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.models import layers, mlp, sharding
from repro_torch.models.config import MoEConfig

# MoE layer applications by dispatch path: "one_block", "blocked", "ep"
_DISPATCH = collections.Counter()


def dispatch_counts() -> dict:
    return {k: _DISPATCH[k] for k in ("one_block", "blocked", "ep")}


def reset_dispatch_counts() -> None:
    _DISPATCH.clear()


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


def n_blocks(t: int, n: int) -> int:
    """The JAX package's ``_data_shards`` rule: ``n`` dispatch blocks (the
    data-shard count), halved while they do not divide the ``t`` tokens
    or would hold fewer than 256 each (the minimum of 8 slots an expert
    would inflate smaller blocks' capacity padding)."""
    while n > 1 and (t % n != 0 or t // n < 256):
        n //= 2
    return max(n, 1)


def _experts(p, buf: torch.Tensor, activation: str) -> torch.Tensor:
    """The expert FFNs on an (E, cap, d) buffer, one batched matmul per
    projection, in the buffer's dtype."""
    dt = buf.dtype
    up = torch.bmm(buf, p["w_up"].to(dt))
    if activation in mlp.GATED:
        h = mlp._act(activation, torch.bmm(buf, p["w_gate"].to(dt))) * up
    else:
        h = mlp._act(activation, up)
    return torch.bmm(h, p["w_down"].to(dt))


def _dispatch(xf: torch.Tensor, flat_ids: torch.Tensor, keep: torch.Tensor,
              pos: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """The (e, cap, d) buffer: each kept assignment's token in its slot,
    the dropped ones to a scratch row that is discarded."""
    k = flat_ids.shape[0] // xf.shape[0]
    token_idx = torch.arange(xf.shape[0], device=xf.device
                             ).repeat_interleave(k)
    slot = torch.where(keep, flat_ids * cap + pos, e * cap)
    return torch.zeros((e * cap + 1, xf.shape[1]), dtype=xf.dtype,
                       device=xf.device).index_copy(
        0, slot, xf[token_idx])[:e * cap].view(e, cap, xf.shape[1])


def _combine(out_buf: torch.Tensor, flat_ids: torch.Tensor,
             pos: torch.Tensor, keep: torch.Tensor, probs: torch.Tensor,
             t: int) -> torch.Tensor:
    """Each token's kept rows times its probabilities, summed in rank
    order through a (t, k, d) view (no atomics), in ``probs``' dtype."""
    e, cap, d = out_buf.shape
    gathered = out_buf.reshape(e * cap, d)[torch.where(
        keep, flat_ids * cap + pos, 0)]
    gathered = torch.where(keep[:, None], gathered.to(probs.dtype), 0.0)
    weighted = (gathered * probs.reshape(-1)[:, None]).view(t, -1, d)
    y = weighted[:, 0]
    for j in range(1, weighted.shape[1]):
        y = y + weighted[:, j]
    return y


def _one_block(p, xf: torch.Tensor, ids: torch.Tensor, probs: torch.Tensor,
               mcfg: MoEConfig, activation: str) -> torch.Tensor:
    """One dispatch block of ``xf``'s tokens with its own capacity."""
    t = xf.shape[0]
    e = mcfg.num_experts
    cap = _capacity(t, mcfg)
    flat_ids = ids.reshape(-1)
    pos, keep = _positions_in_expert(flat_ids, e, cap)
    buf = _dispatch(xf, flat_ids, keep, pos, e, cap)
    return _combine(_experts(p, buf, activation), flat_ids, pos, keep,
                    probs, t)


def apply_moe(p, x: torch.Tensor, mcfg: MoEConfig, activation: str,
              n_blocks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss * router_aux_loss).

    The JAX package's ``_apply_moe_gspmd`` on one device: ``n_blocks``
    dispatch blocks of T / n_blocks consecutive tokens, each with its own
    capacity (its block count is the mesh's data-shard count, 1 off a
    mesh; the caller gives the count :func:`n_blocks` settles on)."""
    b, s, d = x.shape
    t = b * s
    if t % n_blocks:
        raise ValueError(f"{t} tokens in {n_blocks} blocks")
    xf = x.reshape(t, d)
    ids, probs, aux = route(p, xf, mcfg)
    _DISPATCH["one_block" if n_blocks == 1 else "blocked"] += 1
    tl = t // n_blocks
    y = torch.cat([_one_block(p, xf[i * tl:(i + 1) * tl],
                              ids[i * tl:(i + 1) * tl],
                              probs[i * tl:(i + 1) * tl], mcfg, activation)
                   for i in range(n_blocks)])
    return y.reshape(b, s, d), aux * mcfg.router_aux_loss


# ----------------------------------------------------------- on a mesh -----

def _take(xs: Sequence[torch.Tensor], ranges: Sequence[Tuple[int, int]],
          lo: int, hi: int, k: int) -> torch.Tensor:
    """Rows [lo, hi) of the global token order on device k's device, from
    the devices' local (t_i, d) slices ``xs`` covering ``ranges``: from
    device k's own slice where it holds them, else copied."""
    order = [k] + [i for i in range(len(xs)) if i != k]
    dev = xs[k].device
    pieces, cur = [], lo
    while cur < hi:
        i = next(i for i in order if ranges[i][0] <= cur < ranges[i][1])
        end = min(hi, ranges[i][1])
        pieces.append(xs[i][cur - ranges[i][0]:end - ranges[i][0]].to(dev))
        cur = end
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _ep_blocks(t: int, e: int, mesh) -> int:
    """The JAX package's ``_ep_mesh_info``: the block count (one per
    ``("pod", "data")`` shard) where the expert-parallel path applies,
    else 0."""
    m = mesh.n_model
    if m <= 1 or e % m:
        return 0
    nb = mesh.n_rows
    if t % nb or t // nb < 64:
        return 0
    return nb


def _balance_sums(p, xf: torch.Tensor, ids: torch.Tensor, e: int):
    """A block's share of the load-balance loss: the router
    probabilities summed over its tokens and its assignments per expert."""
    probs = torch.softmax(torch.matmul(xf.float(), p["router"]), dim=-1)
    flat = ids.reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=xf.device
                         ).index_add(0, flat, torch.ones(
                             flat.shape, dtype=torch.float32,
                             device=xf.device))
    return probs.sum(0), counts


def apply_moe_mesh(ps: Sequence[dict], xs: Sequence[torch.Tensor],
                   ranges: Sequence[Tuple[int, int]], t: int,
                   mcfg: MoEConfig, activation: str, mesh,
                   expert_spec: sharding.Entry
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The MoE layer on ``mesh``, every device's share.

    ``ps[k]``: device k's parameters (``sharding.local_tree``: the
    experts cut by ``expert_spec``, the fan-in whole); ``xs[k]``: its
    tokens, flattened (t_k, d), rows ``ranges[k]`` of the ``t`` global
    ones.  Returns (each device's (t_k, d) output, aux_loss *
    router_aux_loss on the mesh's first device)."""
    e = mcfg.num_experts
    nb = _ep_blocks(t, e, mesh)
    if nb:
        _DISPATCH["ep"] += 1
        ys, sums = _ep(ps, xs, ranges, t, nb, mcfg, activation, mesh)
    else:
        nb = n_blocks(t, sharding.n_shards("batch", mesh))
        _DISPATCH["blocked" if nb > 1 else "one_block"] += 1
        ys, sums = _blocked(ps, xs, ranges, t, nb, mcfg, activation, mesh,
                            expert_spec)
    dev0 = mesh.devices[0]
    me = sum(s[0].to(dev0) for s in sums) / torch.tensor(
        float(t), device=dev0)
    ce = sum(s[1].to(dev0) for s in sums)
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    aux = (me * ce).sum() * e
    return ys, aux * mcfg.router_aux_loss


def _ep(ps, xs, ranges, t, nb, mcfg, activation, mesh):
    """``_apply_moe_ep``: block r on row r; device (r, j) dispatches the
    assignments of its experts, the fp32 partials summed over model."""
    tl = t // nb
    cap = _capacity(tl, mcfg)
    parts, sums = [], []
    for k in range(mesh.size):
        r, j = mesh.row(k), mesh.col(k)
        p = ps[k]
        el = p["w_up"].shape[0]
        lo = j * el
        x_blk = _take(xs, ranges, r * tl, (r + 1) * tl, k)
        ids, probs, _ = route(p, x_blk, mcfg)
        if j == 0:
            sums.append(_balance_sums(p, x_blk, ids, mcfg.num_experts))
        flat = ids.reshape(-1)
        local = (flat >= lo) & (flat < lo + el)
        ids_loc = torch.where(local, flat - lo, el)
        pos, keep = _positions_in_expert(ids_loc, el + 1, cap)
        keep = keep & local
        ids_safe = torch.where(local, ids_loc, 0)
        buf = _dispatch(x_blk, ids_safe, keep, pos, el, cap)
        parts.append(_combine(_experts(p, buf, activation), ids_safe, pos,
                              keep, probs.float(), tl))
    blocks = [y.to(xs[0].dtype) for y in sharding.psum_model(parts, mesh)]
    block_ranges = [(mesh.row(k) * tl, (mesh.row(k) + 1) * tl)
                    for k in range(mesh.size)]
    return [_take(blocks, block_ranges, *ranges[k], k)
            for k in range(mesh.size)], sums


def _blocked(ps, xs, ranges, t, nb, mcfg, activation, mesh, expert_spec):
    """``_apply_moe_gspmd`` on a mesh: device k dispatches the blocks its
    shard of the (E, nb, cap, d) buffer holds, runs its experts, and
    combines with the other experts' outputs gathered from its row."""
    e = mcfg.num_experts
    tl = t // nb
    cap = _capacity(tl, mcfg)
    blocks_entry = sharding.spec("experts", "batch", None, None,
                                 shape=(e, nb, cap, 1), mesh=mesh)[1]

    def held(k):
        return range(*sharding.block_range(blocks_entry, mesh, k, nb))

    routed, outs, sums, counted = [], [], [], set()
    for k in range(mesh.size):
        p = ps[k]
        el = p["w_up"].shape[0]
        lo = mesh.col(k) * el if el < e else 0
        mine, out_k = [], []
        for b in held(k):
            x_blk = _take(xs, ranges, b * tl, (b + 1) * tl, k)
            ids, probs, _ = route(p, x_blk, mcfg)
            if b not in counted:
                counted.add(b)
                sums.append(_balance_sums(p, x_blk, ids, e))
            flat = ids.reshape(-1)
            pos, keep = _positions_in_expert(flat, e, cap)
            buf = _dispatch(x_blk, flat, keep, pos, e, cap)
            out_k.append(_experts(p, buf[lo:lo + el], activation))
            mine.append((flat, pos, keep, probs))
        routed.append(mine)
        outs.append(out_k)
    ys_blocks: List = []
    for k in range(mesh.size):
        row = [i for i in range(mesh.size) if mesh.row(i) == mesh.row(k)]
        ys_k = []
        for n_b, _ in enumerate(held(k)):
            full = sharding.assemble(
                {i: outs[i][n_b] for i in row}, (expert_spec, None, None),
                mesh, [k] + [i for i in row if i != k], ("model",),
                xs[k].device)
            flat, pos, keep, probs = routed[k][n_b]
            ys_k.append(_combine(full, flat, pos, keep, probs, tl))
        ys_blocks.append(torch.cat(ys_k))
    block_ranges = [(held(k)[0] * tl, (held(k)[-1] + 1) * tl)
                    for k in range(mesh.size)]
    return [_take(ys_blocks, block_ranges, *ranges[k], k)
            for k in range(mesh.size)], sums
