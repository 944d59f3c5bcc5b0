"""Sparse global aggregation and local-model update rules — FedDD Eq. (4)-(6).

Step 4 (server):      W^t     = sum_n m_n * What_n ⊙ M_n  /  sum_n m_n * M_n
Step 7 (client, t mod h != 0): W_n^{t+1} = W^t ⊙ M_n + What_n ⊙ (1 - M_n)
Step 7 (client, t mod h == 0): W_n^{t+1} = W^t

Positions received from NO client keep the previous global value.
Eq. (4) runs through the ``sparse_agg`` kernel in its mean mode (the
division and the previous-global fill inside the kernel), one launch per
leaf, and Eq. (5) through the ``masked_merge`` kernel, one launch for all
the leaves of the tree (of every client on the engine, of one client in
the per-client loop); masks stay channel-shaped (N, 1, ..., C, ..., 1)
and are never broadcast to the parameters' shape.

Only the weighted mean is ported; the Byzantine-robust variants wait for
ROADMAP.md queue A item 12.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import tree
from repro_torch.kernels.masked_merge import ops as merge_ops
from repro_torch.kernels.sparse_agg import ops as agg_ops
# finish_masked_mean lives beside the kernel's plain version (the mean
# mode's reference) and is re-exported here with its EPS
from repro_torch.kernels.sparse_agg.ref import (  # noqa: F401
    EPS, finish_masked_mean)


def leaf_masked_partials(stack_w: torch.Tensor, stack_m: torch.Tensor,
                         w: torch.Tensor):
    """Eq. (4) numerator/denominator of one client-stacked leaf.

    (N, *leaf) values, channel-shaped mask, (N,) fp32 weights ->
    (num, den), each (*leaf) fp32; :func:`finish_masked_mean` turns them
    into the mean (kept apart for a client-sharded engine, which reduces
    the partials across shards first).
    """
    return agg_ops.masked_weighted_sum(stack_w, stack_m, w)


def aggregate_sparse_stacked(stacked_params, stacked_masks, client_weights,
                             *, prev_global=None, robust: str = "mean"):
    """Eq. (4) over client-stacked pytrees (leaves shaped (N, *leaf)).

    ``stacked_masks`` leaves are channel-shaped (N, 1, ..., C, ..., 1) or
    all-ones (N, 1, ..., 1); ``client_weights`` are the (N,) m_n — a zero
    weight leaves that client out of both sums.
    """
    if robust != "mean":
        raise NotImplementedError(
            f"robust_agg {robust!r} is not ported yet (ROADMAP.md queue A "
            "item 12); only 'mean' is")
    leaves, treedef = tree.flatten(stacked_params)
    mleaves = tree.leaves(stacked_masks)
    gleaves = (tree.leaves(prev_global) if prev_global is not None
               else [None] * len(leaves))
    n = leaves[0].shape[0]
    w = torch.as_tensor(client_weights, dtype=torch.float32,
                        device=leaves[0].device)
    if w.shape != (n,):
        raise ValueError("weights count mismatch")
    out = [agg_ops.masked_weighted_mean(sw, sm, w, gprev, sw.dtype)
           for sw, sm, gprev in zip(leaves, mleaves, gleaves)]
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
