"""Sparse global aggregation and local-model update rules — FedDD Eq. (4)-(6).

Step 4 (server):      W^t     = sum_n m_n * What_n ⊙ M_n  /  sum_n m_n * M_n
Step 7 (client, t mod h != 0): W_n^{t+1} = W^t ⊙ M_n + What_n ⊙ (1 - M_n)
Step 7 (client, t mod h == 0): W_n^{t+1} = W^t

Positions received from NO client keep the previous global value.
Eq. (4) runs through the ``sparse_agg`` kernel in its mean mode (the
division and the previous-global fill inside the kernel), one launch per
leaf, and Eq. (5) through the ``masked_merge`` kernel, one launch for all
the leaves of the tree (of every client on the engine, of one client in
the per-client loop); on a homogeneous fleet masks stay channel-shaped
(N, 1, ..., C, ..., 1) and are never broadcast to the parameters' shape.
A ragged fleet (:func:`aggregate_sparse_grouped`, and the per-client
loop's padded uploads) aggregates on a full-width canvas whose masks are
elementwise: a narrow client's zero padding covers input channels too,
so Eq. (4) takes the kernel's elementwise-mask mode there.

Byzantine-robust variants (``robust=`` on the stacked entry point, from
``ProtocolConfig.robust_agg``), the JAX package's two hardenings:

* ``"trimmed[:beta]"`` — coordinate-wise trimmed mean: per coordinate,
  among the clients that uploaded it with positive weight, drop the
  ``floor(beta * n_valid)`` largest and smallest values and weighted-
  average the rest (default beta 0.1); a coordinate with no survivor
  keeps the previous global.  Eager torch (two stable sorts a leaf).
* ``"clip[:factor]"`` — per-client norm clipping: each client's masked
  update ``(What_n - W^{t-1}) ⊙ M_n`` is scaled down to at most
  ``factor`` x the median participant update norm (default 1.0), then
  the Eq. (4) partials through the ``sparse_agg`` kernel's partials mode
  and the eager finish.  Requires ``prev_global``.

``"mean"`` (the default) is the kernel's mean mode, unchanged.

Deadline partial aggregation (the simulator's ``DeadlinePolicy(partial=
True)``) cuts a client's channel mask to the prefix of kept channels
whose bytes landed before the deadline
(:func:`truncate_masks_to_prefix`); the cut masks go to the same mean
mode, while Eq. (5) keeps the full masks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.kernels.masked_merge import ops as merge_ops
from repro_torch.kernels.sparse_agg import ops as agg_ops
# finish_masked_mean lives beside the kernel's plain version (the mean
# mode's reference) and is re-exported here with its EPS
from repro_torch.kernels.sparse_agg.ref import (  # noqa: F401
    EPS, finish_masked_mean)


def leaf_masked_partials(stack_w: torch.Tensor, stack_m: torch.Tensor,
                         w: torch.Tensor, select: bool = False):
    """Eq. (4) numerator/denominator of one client-stacked leaf.

    (N, *leaf) values, channel-shaped mask, (N,) fp32 weights ->
    (num, den), each (*leaf) fp32; :func:`finish_masked_mean` turns them
    into the mean (kept apart for a client-sharded engine, which reduces
    the partials across shards first).  ``select``: a masked-out term adds
    nothing to num (:func:`select_leaf`).
    """
    return agg_ops.masked_weighted_sum(stack_w, stack_m, w, select=select)


def select_leaf(stack_w: torch.Tensor, compiled: bool) -> bool:
    """Whether Eq. (4) of this client-stacked leaf skips its masked-out
    terms, as the JAX package computes it: its compiled engine steps
    (``BatchedRoundEngine`` and the sharded steps, with masks straight
    from the top-k compare, i.e. no delivered prefixes: ``compiled``)
    see XLA rewrite ``W * convert(mask)`` into a select at the 1-D leaves,
    whose (N, C) mask is not broadcast; every other leaf, and every eager
    path, computes ``W * M * w`` and lets a NaN * 0 through
    (``scripts/c5_select_rule.py`` finds this on the MLP, CNN1 and VGG)."""
    return bool(compiled) and stack_w.ndim == 2


ROBUST_AGGS = ("mean", "trimmed", "clip")


def parse_robust_agg(spec: Optional[str]) -> Tuple[str, float]:
    """``"mean" | "trimmed[:beta]" | "clip[:factor]"`` -> (kind, param)."""
    if spec is None:
        spec = "mean"
    name, _, arg = str(spec).partition(":")
    if name == "mean":
        if arg:
            raise ValueError("robust_agg 'mean' takes no parameter")
        return "mean", 0.0
    if name == "trimmed":
        beta = float(arg) if arg else 0.1
        if not 0.0 <= beta < 0.5:
            raise ValueError(f"trimmed beta must be in [0,0.5), got {beta}")
        return "trimmed", beta
    if name == "clip":
        c = float(arg) if arg else 1.0
        if c <= 0.0:
            raise ValueError(f"clip factor must be > 0, got {c}")
        return "clip", c
    raise ValueError(f"unknown robust_agg {spec!r} — expected one of "
                     f"{ROBUST_AGGS} (optionally 'trimmed:<beta>' / "
                     "'clip:<factor>')")


def _client_view(w: torch.Tensor, ndim: int) -> torch.Tensor:
    return w.view((-1,) + (1,) * (ndim - 1))


def leaf_trimmed_partials(stack_w: torch.Tensor, stack_m: torch.Tensor,
                          w: torch.Tensor, beta: float):
    """Coordinate-wise trimmed (num, den) of one client-stacked leaf.

    The valid contributors of a coordinate are the clients with mask 1 and
    positive weight; they are ranked by value (a stable argsort of the
    argsort, invalid rows keyed to +inf so they rank past the valid tail),
    and the ``floor(beta * n_valid)`` lowest and highest are dropped
    before the weighted Eq. (4) sums."""
    wts = _client_view(w, stack_w.ndim)
    vals = stack_w.float()
    valid = ((stack_m > 0) & (wts > 0)).expand(stack_w.shape)
    n_valid = valid.sum(0)
    k = torch.floor(beta * n_valid.float()).to(n_valid.dtype)
    order = torch.argsort(torch.where(valid, vals, torch.inf), dim=0,
                          stable=True)
    rank = torch.argsort(order, dim=0, stable=True)
    keep = valid & (rank >= k) & (rank < n_valid - k)
    ww = stack_m * wts * keep
    return (vals * ww).sum(0), ww.sum(0)


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """numpy's (and jax's) nanmedian of a 1-D tensor — the mean of the two
    middle values for an even count, NaN when every value is NaN — as a
    0-D tensor, with no host sync (``torch.nanmedian`` takes the lower
    middle value)."""
    s = torch.sort(x).values                         # NaN sorts last
    cnt = (~torch.isnan(x)).sum().float()
    q = 0.5 * (cnt - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    top = cnt - 1.0

    def at(i):
        i = torch.clamp(torch.minimum(i, top), min=0.0).long().view(1)
        return s.gather(0, i)[0]

    return at(low) * (1.0 - hw) + at(high) * hw


def _clip_scales(deltas, w: torch.Tensor, factor: float) -> torch.Tensor:
    """(N,) clip scales from the masked-update leaf deltas: each client's
    whole-tree update norm is clipped to ``factor`` x the median norm of
    the positive-weight participants (scale 1 where it is below)."""
    sq = None
    for d in deltas:
        s = torch.sum(d * d, dim=tuple(range(1, d.ndim)))
        sq = s if sq is None else sq + s
    norms = torch.sqrt(sq)
    ref = _nanmedian(torch.where(w > 0, norms, torch.nan))
    scale = torch.clamp(factor * ref / torch.clamp(norms, min=EPS), max=1.0)
    return torch.where(torch.isfinite(scale), scale, 1.0)


def robust_leaf_stacks(stacks_w, stacks_m, w: torch.Tensor, gleaves,
                       kind: str, arg: float, compiled: bool = False):
    """Eq. (4) of each (N, *leaf) stack with its channel-shaped mask under
    the variant ``kind`` (the clip variant needs the whole tree at once
    for its per-client norms); ``compiled``: the mean skips masked-out
    terms where :func:`select_leaf` says."""
    if kind == "mean":
        return [agg_ops.masked_weighted_mean(
                    sw, sm, w, gp, sw.dtype,
                    select=select_leaf(sw, compiled))
                for sw, sm, gp in zip(stacks_w, stacks_m, gleaves)]
    if kind == "trimmed":
        return [finish_masked_mean(*leaf_trimmed_partials(sw, sm, w, arg),
                                   gp, sw.dtype)
                for sw, sm, gp in zip(stacks_w, stacks_m, gleaves)]
    if kind == "clip":
        if any(gp is None for gp in gleaves):
            raise ValueError("robust_agg 'clip' needs prev_global (the "
                             "clipped quantity is the update vs W^{t-1})")
        deltas = [(sw.float() - gp.float()) * sm
                  for sw, sm, gp in zip(stacks_w, stacks_m, gleaves)]
        scale = _clip_scales(deltas, w, arg)
        out = []
        for d, sw, sm, gp in zip(deltas, stacks_w, stacks_m, gleaves):
            vals = gp.float() + d * _client_view(scale, d.ndim)
            num, den = leaf_masked_partials(vals, sm.float(), w)
            out.append(finish_masked_mean(num, den, gp, sw.dtype))
        return out
    raise ValueError(f"unknown robust kind {kind!r}")


def aggregate_sparse_stacked(stacked_params, stacked_masks, client_weights,
                             *, prev_global=None, robust: str = "mean",
                             compiled: bool = False):
    """Eq. (4) over client-stacked pytrees (leaves shaped (N, *leaf)).

    ``stacked_masks`` leaves are channel-shaped (N, 1, ..., C, ..., 1) or
    all-ones (N, 1, ..., 1); ``client_weights`` are the (N,) m_n — a zero
    weight leaves that client out of both sums.  ``robust`` picks the
    variant (module docstring); ``"mean"`` is the kernel's mean mode.
    ``compiled``: Eq. (4) as the JAX package's compiled engine step
    computes it (:func:`select_leaf`); False, the literal ``W * M * w``
    of its eager code.
    """
    kind, arg = parse_robust_agg(robust)
    leaves, treedef = tree.flatten(stacked_params)
    mleaves = tree.leaves(stacked_masks)
    gleaves = (tree.leaves(prev_global) if prev_global is not None
               else [None] * len(leaves))
    n = leaves[0].shape[0]
    w = torch.as_tensor(client_weights, dtype=torch.float32,
                        device=leaves[0].device)
    if w.shape != (n,):
        raise ValueError("weights count mismatch")
    return tree.unflatten(treedef, robust_leaf_stacks(
        leaves, mleaves, w, gleaves, kind, arg, compiled))


def pad_to(x: torch.Tensor, shape) -> torch.Tensor:
    """Zero-pad every axis of ``x`` at its end up to ``shape`` (x itself
    where nothing pads)."""
    pads = []
    for xs, gs in zip(reversed(x.shape), reversed(tuple(shape))):
        pads += [0, gs - xs]
    return x if not any(pads) else torch.nn.functional.pad(x, pads)


def aggregate_sparse_grouped(group_params: Sequence, group_masks: Sequence,
                             group_indices: Sequence[torch.Tensor],
                             client_weights, global_template, *,
                             prev_global=None, single_canvas: bool = True,
                             robust: str = "mean"):
    """Eq. (4) over a shape-grouped ragged fleet: every group's stacked
    sub-model leaves land in a full-width client canvas, which the shared
    leaf reduction then takes.

    The canvas equals the per-client loop's (each client zero-padded to
    global widths, its mask broadcast to its values and zero-padded, all N
    stacked): group rows sit at their fleet positions, the un-owned tail
    stays zero, and a zero mask adds to neither Eq. (4) sum.  So the
    grouped and the loop's aggregation launch the same kernel on the same
    canvas.  The masks are elementwise there; a 1-D leaf's canvas mask is
    its own shape, a channel mask.

    Args:
      group_params: per group, a stacked pytree with leaves (n_g, *local).
      group_masks: per group, channel-shaped stacked masks
        (n_g, 1, ..., C_local, ..., 1) (or all-ones (n_g, 1, ..., 1)).
      group_indices: per group, the members' canvas rows as an (n_g,)
        int64 tensor on the leaves' device.
      client_weights: (N,) weights m_n by canvas row; 0 drops the row.
      global_template: pytree with the full-model leaf shapes and dtypes.
      prev_global: fills the positions no client uploaded.
      single_canvas: pad every group to global widths, concatenate and
        land all N rows with one ``index_copy_`` a leaf (default); False
        writes group by group into the canvas, the reference the
        equivalence tests hold the default to (equal bit for bit).
      robust: the Eq. (4) variant (module docstring).

    Returns the aggregated full-width global pytree.
    """
    kind, arg = parse_robust_agg(robust)
    g_leaves, treedef = tree.flatten(global_template)
    gprev = (tree.leaves(prev_global) if prev_global is not None
             else [None] * len(g_leaves))
    leaves = [tree.leaves(p) for p in group_params]
    mleaves = [tree.leaves(m) for m in group_masks]
    dev = g_leaves[0].device
    w = torch.as_tensor(client_weights, dtype=torch.float32, device=dev)
    n = w.shape[0]
    all_rows = torch.cat(list(group_indices)) if single_canvas else None
    out, stacks_w, stacks_m = [], [], []
    for li, gl in enumerate(g_leaves):
        stack_w = torch.zeros((n,) + tuple(gl.shape), dtype=gl.dtype,
                              device=dev)
        stack_m = torch.zeros_like(stack_w)
        if single_canvas:
            pads_w, pads_m = [], []
            for gi in range(len(group_indices)):
                lw = leaves[gi][li]                        # (n_g, *local)
                lm = mleaves[gi][li].to(gl.dtype).expand(lw.shape)
                pads_w.append(pad_to(lw.to(gl.dtype), stack_w.shape[1:]))
                pads_m.append(pad_to(lm, stack_w.shape[1:]))
            stack_w.index_copy_(0, all_rows, torch.cat(pads_w))
            stack_m.index_copy_(0, all_rows, torch.cat(pads_m))
        else:
            for gi, idx in enumerate(group_indices):
                lw = leaves[gi][li]
                lm = mleaves[gi][li].to(gl.dtype).expand(lw.shape)
                box = (slice(None),) + tuple(slice(0, s)
                                             for s in lw.shape[1:])
                sub_w = stack_w[box]
                sub_m = stack_m[box]
                sub_w.index_copy_(0, idx, lw.to(gl.dtype))
                sub_m.index_copy_(0, idx, lm.contiguous())
        if kind == "mean":      # one leaf's canvas at a time
            out += robust_leaf_stacks([stack_w], [stack_m], w, [gprev[li]],
                                      kind, arg)
        else:                   # clip needs every leaf's update at once
            stacks_w.append(stack_w)
            stacks_m.append(stack_m)
    if kind != "mean":
        out = robust_leaf_stacks(stacks_w, stacks_m, w, gprev, kind, arg)
    return tree.unflatten(treedef, out)


def aggregate_sparse(client_params: Sequence, client_masks: Sequence,
                     client_weights, *, prev_global=None):
    """Eq. (4) over lists of client pytrees (the per-client loop's form).

    Each client's leaves and channel-shaped masks are stacked and go
    through the same per-leaf mean-mode kernel as
    :func:`aggregate_sparse_stacked`, so the two agree bit for bit.
    """
    n = len(client_params)
    if len(client_masks) != n:
        raise ValueError("params/masks count mismatch")
    if len(client_weights) != n:
        raise ValueError("weights count mismatch")
    return aggregate_sparse_stacked(
        tree.tree_map(lambda *ls: torch.stack(ls), *client_params),
        tree.tree_map(lambda *ms: torch.stack(ms), *client_masks),
        client_weights, prev_global=prev_global)


def truncate_masks_to_prefix(stacked_masks, delivered):
    """Keep only each client's first ``delivered[leaf][n]`` kept channels.

    Kept channels serialize in ascending channel index
    (``comm.payload.delivered_prefix_counts``), so the bytes of a cut
    upload are, per leaf, the prefix of the mask's kept set.
    ``stacked_masks`` leaves are channel-shaped (N, 1, ..., C, ..., 1);
    ``delivered`` is one (N,) integer vector per mask leaf (flatten
    order), a tensor on the masks' device or a host array.  A count at
    or above the leaf's kept total (``iinfo(int32).max``: everything
    arrived) leaves that client's mask as it was.  The rank is a float32
    cumulative sum compared with ``k`` cast to float32, as the JAX
    package computes it: exact for C < 2^24.  A scalar or one-channel
    leaf keeps its mask where ``k >= 1``.
    """
    mleaves, treedef = tree.flatten(stacked_masks)
    if len(delivered) != len(mleaves):
        raise ValueError("delivered counts / mask leaves mismatch")
    out = []
    for m, k in zip(mleaves, delivered):
        k = torch.as_tensor(k, device=m.device).to(torch.float32)
        if m.ndim <= 1:                      # scalar leaf: one channel
            out.append(m * (k >= 1.0).to(m.dtype).view(m.shape))
            continue
        ax = next((a for a in range(1, m.ndim) if m.shape[a] > 1),
                  m.ndim - 1)
        rank = torch.cumsum(m, dim=ax, dtype=torch.float32)
        kb = k.view((-1,) + (1,) * (m.ndim - 1))
        out.append(m * (rank <= kb).to(m.dtype))
    return tree.unflatten(treedef, out)


def client_update_sparse(global_params, local_params, masks):
    """Eq. (5): W_n^{t+1} = W^t ⊙ M_n + What_n ⊙ (1 - M_n).

    ``global_params`` is un-stacked.  ``local_params`` and the
    channel-shaped ``masks`` either carry the client axis (every client
    of the stacked engine) or not (one client of the per-client loop, a
    group of N = 1).  The leaves go to the kernel as one group (one
    launch per dtype on the card).
    """
    gl, gdef = tree.flatten(global_params)
    ll, ldef = tree.flatten(local_params)
    ml, mdef = tree.flatten(masks)
    if not gdef == ldef == mdef:
        raise ValueError("tree structure mismatch")
    if all(l.ndim == g.ndim for g, l in zip(gl, ll)):      # one client
        merged = merge_ops.masked_merge_many(
            gl, [l[None] for l in ll], [m[None] for m in ml])
        return tree.unflatten(ldef, [o[0] for o in merged])
    return tree.unflatten(ldef, merge_ops.masked_merge_many(gl, ll, ml))


def client_update_full(global_params, local_params):
    """Eq. (6): W_n^{t+1} = W^t (full broadcast round)."""
    del local_params
    return tree.tree_map(lambda g: g, global_params)


def fedavg_aggregate(client_params: Sequence, client_weights):
    """Classic Eq. (3) dense FedAvg over a list of pytrees (baseline)."""
    w = torch.as_tensor(client_weights, dtype=torch.float32)
    w = w / w.sum()

    def _avg(*ls):
        stack = torch.stack([l.float() for l in ls])
        wts = w.to(stack.device).view((-1,) + (1,) * (stack.ndim - 1))
        return (stack * wts).sum(0).to(ls[0].dtype)

    return tree.tree_map(_avg, *client_params)
