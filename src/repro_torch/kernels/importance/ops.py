"""Wrapper of the importance kernel (``csrc/importance.cu``) and its work
plan: how many blocks split each (client, channel tile)'s fan-in rows."""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.importance.ref import channel_importance_ref

TILE = 32            # channels per block (csrc/importance.cu kTile)
THREADS = 256        # threads per block (kThreads)
MAX_SPLITS = 8       # blocks per cluster, the portable limit (kMaxSplits)
UNROLL = 4           # rows a thread loads at once (kUnroll)
BLOCKS_PER_SM = 2    # the split aims at 2-4 blocks per SM


class WorkPlan(NamedTuple):
    tile: int        # channels per block
    vec: int         # channels per load
    splits: int      # blocks (one cluster) per (client, tile)
    blocks: int      # the grid's size


def work_plan(n: int, a: int, c: int, b: int, sms: int,
              vec: int = 1) -> WorkPlan:
    """The grid for an (N, A, C, B) leaf on a card with ``sms`` SMs.

    ``N * ceil(C / TILE)`` blocks cover the leaf.  When that fills the
    card (at least one block per SM) each block reduces all A * B fan-in
    rows.  Otherwise the rows are split across S blocks, so the grid
    reaches BLOCKS_PER_SM blocks per SM, with S at most MAX_SPLITS and no
    more splits than leave each of a block's row slices a full step of
    UNROLL rows (a cluster launch costs more than a step of loads).
    """
    base = n * math.ceil(c / TILE)
    slices = THREADS // (TILE // vec)
    splits = 1
    if base < sms:
        splits = min(MAX_SPLITS, math.ceil(BLOCKS_PER_SM * sms / base),
                     math.ceil(a * b / (slices * UNROLL)))
    return WorkPlan(TILE, vec, splits, base * splits)


def split_rows(rows: int, splits: int) -> List[Tuple[int, int]]:
    """The fan-in rows [begin, end) of each split, as the kernel takes
    them: contiguous, in rank order, each row exactly once."""
    return [(rows * s // splits, rows * (s + 1) // splits)
            for s in range(splits)]


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """SMs of the card ``device`` names (the tensors' own card)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def channel_importance_batched(w_old: torch.Tensor, w_new: torch.Tensor, *,
                               channel_axis: int = -1,
                               coverage: Optional[torch.Tensor] = None,
                               per_client_split: bool = False
                               ) -> torch.Tensor:
    """Client-stacked Eq. (20)/(21): (N, *leaf) x2 -> (N, C) fp32.

    ``channel_axis`` indexes the un-stacked leaf.  The leaf is read in
    place as (N, A, C, B) around its channel axis.  The fan-in split
    fixes each score's summation order; ``per_client_split`` plans it as
    for one client, so every row has the bits of a one-client launch (the
    grouped engine, whose oracle is the per-client loop).  Launches count
    by route, "coverage" where the Eq. (21) division runs and "plain"
    otherwise (:func:`route_counts`).  A launch reports its cost to an
    active cost counter: 5 operations an element, both leaves read once,
    the (N, C) fp32 scores written once.
    """
    if w_old.shape != w_new.shape or w_old.dtype != w_new.dtype:
        raise ValueError(f"w_old {tuple(w_old.shape)}/{w_old.dtype} and "
                         f"w_new {tuple(w_new.shape)}/{w_new.dtype} differ")
    if w_old.ndim < 2:
        raise ValueError("need a client-stacked leaf of rank >= 1")
    _lib.check_dtype("w_old", w_old, _lib.DTYPE_CODES)
    n = w_old.shape[0]
    a, c, b = _lib.split_at(w_old.shape[1:], channel_axis % (w_old.ndim - 1))
    tensors = [w_old, w_new]
    if coverage is not None:
        _lib.check_dtype("coverage", coverage, (torch.float32,))
        if tuple(coverage.shape) != (c,):
            raise ValueError(f"coverage must be ({c},), got "
                             f"{tuple(coverage.shape)}")
        tensors.append(coverage)
    dev = _lib.kernel_device(*tensors)
    _lib.check_contiguous(w_old=w_old, w_new=w_new,
                          **({} if coverage is None else
                             {"coverage": coverage}))
    if dev == "cpu":
        return channel_importance_ref(w_old.view(n, a, c, b),
                                      w_new.view(n, a, c, b), coverage)
    vec = _lib.vector_width(c, w_old, w_new) if b == 1 else 1
    plan = work_plan(1 if per_client_split else n, a, c, b,
                     sm_count(w_old.device), vec)
    out = torch.empty((n, c), dtype=torch.float32, device=w_old.device)
    _lib.launch("importance", "feddd_importance", w_old.data_ptr(),
                w_new.data_ptr(),
                None if coverage is None else coverage.data_ptr(),
                out.data_ptr(), n, a, c, b, plan.vec, plan.splits,
                _lib.DTYPE_CODES[w_old.dtype], device=w_old.device,
                route="plain" if coverage is None else "coverage")
    _lib.report_cost("importance", lambda: (
        5 * w_old.numel(),
        2 * w_old.numel() * w_old.element_size() + n * c * 4
        + (0 if coverage is None else c * 4)))
    return out


def route_counts():
    """Launches with and without the coverage division since
    ``kernels.reset_launch_counts``."""
    return _lib.route_launches("importance", ("plain", "coverage"))
