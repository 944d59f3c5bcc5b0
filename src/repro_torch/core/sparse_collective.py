"""Compacted sparse collectives: FedDD's upload step across client shards.

A client uploads ``W ⊙ M``, only its kept channels.  Across the shards of
a client mesh the analogous expensive hop is the cross-device exchange of
the per-shard Eq. (4) partials, and FedDD's channel-structured dropout
lets each shard move only the channels it holds:

  1. rank the channels (by importance, or by the denominator mass) and
     keep ``K`` of them (a fixed buffer size);
  2. compact the kept channels into a ``(K, fan_in)`` buffer plus a
     ``(K,)`` int32 index vector;
  3. gather every shard's buffers (``P·K·fan_in`` values + ``P·K``
     indices);
  4. scatter-add them into a dense accumulator and divide (Eq. (4)).

The JAX package writes these inside ``shard_map`` over a named mesh axis.
Here one process drives every shard (a :class:`~repro_torch.launch.mesh
.ClientMesh`), so each function takes **per-shard lists** — element p is
what shard p holds, on ``mesh.devices[p]`` — and returns the replicated
result once per shard, on that shard's device (the same tensor for every
shard of a virtual mesh: nothing is copied).  The gather is the list
itself; rows of another card move with non-blocking copies to the mesh's
first device, where the reduction runs.

Determinism: the scatter-add is one ``index_add_`` per shard, in shard
order; indices are unique within one shard's buffer, so no two additions
of one ``index_add_`` land on one position and two runs are bit-equal
(CUDA's ``index_add_`` uses atomics, whose order is not fixed for
duplicates).  Ties in :func:`compact_topk` keep the lower index, as
``lax.top_k`` does: a stable descending sort, never ``torch.topk``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import ClientMesh

_EPS = 1e-12


def compact_topk(values: torch.Tensor, scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-``k`` channels (axis-0 rows) of ``values`` by ``scores``:
    (compacted (k, ...), indices (k,) int32), ties to the lower index."""
    idx = torch.sort(scores, descending=True, stable=True).indices[:k]
    return values.index_select(0, idx), idx.to(torch.int32)


def scatter_accumulate(dense_shape, compact: torch.Tensor, idx: torch.Tensor,
                       weights: Union[torch.Tensor, float] = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-add the ``compact`` rows into a dense (C, ...) float32
    accumulator -> (sum, count): count[c] is the total weight of the
    contributions to channel c (the Eq. (4) division's)."""
    dev = compact.device
    w = torch.broadcast_to(torch.as_tensor(weights, dtype=torch.float32,
                                           device=dev), idx.shape)
    idx = idx.long()
    wshape = (idx.shape[0],) + (1,) * (compact.ndim - 1)
    num = torch.zeros(tuple(dense_shape), dtype=torch.float32, device=dev)
    cnt = torch.zeros((dense_shape[0],), dtype=torch.float32, device=dev)
    num.index_add_(0, idx, compact.float() * w.reshape(wshape))
    cnt.index_add_(0, idx, w)
    return num, cnt


def _check(mesh: ClientMesh, *lists) -> None:
    for parts in lists:
        if parts is not None and len(parts) != mesh.num_shards:
            raise ValueError(f"{len(parts)} per-shard values for a mesh of "
                             f"{mesh.num_shards} shards")


def on_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: itself when it is there already, else a
    non-blocking copy."""
    return t if t.device == dev else t.to(dev, non_blocking=True)


def replicate(t: torch.Tensor, mesh: ClientMesh) -> List[torch.Tensor]:
    """``t`` (on the mesh's first device) once per shard, on its device."""
    return [on_device(t, d) for d in mesh.devices]


def _per_shard(x, mesh: ClientMesh) -> list:
    """A scalar (or one tensor) for every shard, or a per-shard list."""
    if isinstance(x, (list, tuple)):
        _check(mesh, x)
        return list(x)
    return [x] * mesh.num_shards


def _live_rows(k: int, k_local, dev) -> Optional[torch.Tensor]:
    """(k,) float32: 1 for the first ``k_local`` rows, else 0."""
    if k_local is None:
        return None
    kl = torch.as_tensor(k_local, device=dev)
    return (torch.arange(k, device=dev) < kl).to(torch.float32)


def sparse_allgather_mean(locals_: Sequence[torch.Tensor],
                          scores: Sequence[torch.Tensor], k: int,
                          mesh: ClientMesh, weight=1.0,
                          k_local=None) -> List[torch.Tensor]:
    """FedDD aggregation across the shards with compacted transfer.

    Each shard contributes its top-``k`` channels of ``locals_[p]`` by
    ``scores[p]`` at its weight; a position no shard contributed keeps the
    shard's LOCAL value (the caller overlays the h-periodic dense sync).
    ``weight`` and ``k_local`` (a keep count <= k: rows past it weigh 0,
    differential dropout on a fixed buffer) are scalars or per-shard
    lists.  Returns one tensor per shard, shaped and typed like its local.
    """
    _check(mesh, locals_, scores)
    dev0 = mesh.devices[0]
    weights = _per_shard(weight, mesh)
    kls = _per_shard(k_local, mesh)
    shape = locals_[0].shape
    num = torch.zeros(tuple(shape), dtype=torch.float32, device=dev0)
    cnt = torch.zeros((shape[0],), dtype=torch.float32, device=dev0)
    for loc, sc, w, kl in zip(locals_, scores, weights, kls):
        compact, idx = compact_topk(loc, sc, k)
        w_rows = torch.full((k,), 1.0, dtype=torch.float32,
                            device=loc.device) * torch.as_tensor(
            w, dtype=torch.float32, device=loc.device)
        live = _live_rows(k, kl, loc.device)
        if live is not None:
            w_rows = w_rows * live
        wshape = (k,) + (1,) * (compact.ndim - 1)
        idx0 = on_device(idx, dev0).long()
        num.index_add_(0, idx0, on_device(compact.float() * w_rows.reshape(
            wshape), dev0))
        cnt.index_add_(0, idx0, on_device(w_rows, dev0))
    wshape = (shape[0],) + (1,) * (len(shape) - 1)
    agg = num / torch.clamp(cnt, min=_EPS).reshape(wshape)
    keep_local = (cnt <= _EPS).reshape(wshape)
    out = []
    for loc, a, kl in zip(locals_, replicate(agg, mesh),
                          replicate(keep_local, mesh)):
        out.append(torch.where(kl, loc, a.to(loc.dtype)).to(loc.dtype))
    return out


def sparse_numden_allreduce(nums: Sequence[torch.Tensor],
                            den_chs: Sequence[torch.Tensor], k: int,
                            mesh: ClientMesh, k_local=None
                            ) -> Tuple[List[torch.Tensor],
                                       List[torch.Tensor],
                                       List[torch.Tensor]]:
    """The compacted reduction of per-shard Eq. (4) partials: ``nums[p]``
    (C, ...) float32 channel-major, ``den_chs[p]`` its (C,) channel
    denominator profile.  Each shard ships its top-``k`` channels by den
    mass with their indices and den rows; the reduced (num, den) are
    returned for the caller's weighted division and previous-global fill.

    A channel with den 0 has exactly-zero num rows, so the compaction
    loses nothing while a shard's nonzero-channel count fits the buffer;
    ``overflow`` (the sum over shards of ``max(0, nnz - k)``, 0-D float32)
    counts the channels that did not fit: 0 certifies the result equals
    the dense sum up to reduction order.  ``k_local`` (a scalar or per
    shard, <= k) zeroes the rows past it.

    Returns ``(num_total, den_total, overflow)``, each a per-shard list.
    """
    _check(mesh, nums, den_chs)
    dev0 = mesh.devices[0]
    kls = _per_shard(k_local, mesh)
    c = nums[0].shape[0]
    k = max(1, min(int(k), c))
    num_tot = torch.zeros(tuple(nums[0].shape), dtype=torch.float32,
                          device=dev0)
    den_tot = torch.zeros((c,), dtype=torch.float32, device=dev0)
    overflow = torch.zeros((), dtype=torch.float32, device=dev0)
    for num, den_ch, kl in zip(nums, den_chs, kls):
        nnz = (den_ch > 0).sum(dtype=torch.float32)
        overflow += on_device(torch.clamp(nnz - k, min=0.0), dev0)
        compact, idx = compact_topk(num, den_ch, k)
        den_rows = den_ch.index_select(0, idx.long())
        live = _live_rows(k, kl, num.device)
        if live is not None:
            compact = compact * live.reshape((k,) + (1,) *
                                             (compact.ndim - 1))
            den_rows = den_rows * live
        idx0 = on_device(idx, dev0).long()
        num_tot.index_add_(0, idx0, on_device(compact.float(), dev0))
        den_tot.index_add_(0, idx0, on_device(den_rows.float(), dev0))
    return (replicate(num_tot, mesh), replicate(den_tot, mesh),
            replicate(overflow, mesh))


def dense_sum(parts: Sequence[torch.Tensor], mesh: ClientMesh
              ) -> torch.Tensor:
    """The shards' tensors summed in shard order on the mesh's first
    device (one shard: the tensor itself, no add)."""
    dev0 = mesh.devices[0]
    tot = on_device(parts[0], dev0)
    for p in parts[1:]:
        tot = tot + on_device(p, dev0)
    return tot


def make_federated_numden_allreduce(keep_fraction: float, mesh: ClientMesh):
    """``f(nums, den_chs, k_local=None) -> (num_tot, den_tot, overflow)``,
    the Eq. (4) partial reducer across the shards, per-shard lists in and
    out.  ``keep_fraction = 1`` is the dense sum (exact, zero overflow);
    below it the compacted buffer holds ``K = max(1, ceil(C *
    keep_fraction))`` channels per shard (:func:`sparse_numden_allreduce`).
    """
    if not 0.0 < keep_fraction <= 1.0:
        raise ValueError(
            f"keep_fraction must be in (0,1], got {keep_fraction}")

    def _f(nums, den_chs, k_local=None):
        _check(mesh, nums, den_chs)
        if keep_fraction >= 1.0:
            zero = torch.zeros((), dtype=torch.float32,
                               device=mesh.devices[0])
            return (replicate(dense_sum([n.float() for n in nums], mesh),
                              mesh),
                    replicate(dense_sum([d.float() for d in den_chs], mesh),
                              mesh),
                    replicate(zero, mesh))
        c = nums[0].shape[0]
        k = max(1, min(c, int(math.ceil(c * keep_fraction))))
        return sparse_numden_allreduce(nums, den_chs, k, mesh,
                                       k_local=k_local)

    return _f


def dense_allreduce_mean(locals_: Sequence[torch.Tensor], mesh: ClientMesh,
                         weight=1.0) -> List[torch.Tensor]:
    """FedAvg across the shards: the weighted dense mean (``weight`` a
    scalar or per shard), once per shard in its local's dtype."""
    _check(mesh, locals_)
    weights = [torch.as_tensor(w, dtype=torch.float32, device=l.device)
               for w, l in zip(_per_shard(weight, mesh), locals_)]
    num = dense_sum([l.float() * w for l, w in zip(locals_, weights)], mesh)
    den = dense_sum(weights, mesh)
    mean = num / den
    return [m.to(l.dtype) for m, l in zip(replicate(mean, mesh), locals_)]


def make_federated_allreduce(k_fraction: float, mesh: ClientMesh):
    """``f(locals, scores, weight=1.0, k_local=None)``: the compacted path
    (:func:`sparse_allgather_mean`, ``k = max(1, int(C * k_fraction))``)
    below ``k_fraction = 1`` (``1 - D``), the dense mean at 1."""
    if not 0.0 < k_fraction <= 1.0:
        raise ValueError(f"k_fraction must be in (0,1], got {k_fraction}")

    def _f(locals_, scores, weight=1.0, k_local=None):
        if k_fraction >= 1.0:
            return dense_allreduce_mean(locals_, mesh, weight)
        k = max(1, int(locals_[0].shape[0] * k_fraction))
        return sparse_allgather_mean(locals_, scores, k, mesh, weight,
                                     k_local=k_local)

    return _f
