"""Wrapper of the masked merge kernel (``csrc/masked_merge.cu``): Eq. (5)
for a group of client-stacked leaves, one launch per dtype and per
``MAX_LEAVES`` descriptors (:func:`plan`).  A client leaf of 2**31
elements or more takes one descriptor per client and per piece, each
piece under 2**31 elements and on a channel boundary (:func:`split_leaf`),
so the kernel keeps its 32-bit indices and its code."""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.masked_merge.ref import masked_merge_ref

THREADS = 128                 # vectors of G per tile: kThreads
CLIENTS = 4                   # most clients per tile: kClients
MAX_LEAVES = 32               # leaf descriptors per launch: kMaxLeaves
MAX_ELEMENTS = 1 << 31        # a descriptor covers fewer (32-bit indices)
MAX_TILES = (1 << 31) - 1     # blocks of one launch (the grid's x limit)
FIELDS = 18                   # int64 per descriptor in the launch table


class LeafSpec(NamedTuple):
    """What the launch plan needs of one leaf."""

    dtype: torch.dtype
    n: int                    # clients
    acb: Tuple[int, int, int]  # (A, C, B) around the channel axis
    mask_c: int               # C, or 1 for an all-ones mask shape
    addrs: Tuple[int, ...]    # addresses of G, L and the output
    mask_addr: int


class Piece(NamedTuple):
    """The part of a client leaf one descriptor covers."""

    offset: int               # its first element within the client leaf
    acb: Tuple[int, int, int]  # its (A, C, B)
    c0: int                   # its first channel


class LeafPlan(NamedTuple):
    index: int                # position in the group
    vec: int                  # V, elements per access
    chunk: int                # clients per tile
    tile_begin: int           # first tile: sum of the earlier leaves' tiles
    tiles: int                # ceil(size / V / THREADS) * ceil(N / chunk)
    spec: Optional[LeafSpec] = None   # what the descriptor covers


class Launch(NamedTuple):
    dtype: torch.dtype
    leaves: Tuple[LeafPlan, ...]
    tiles: int                # the grid


def divmod_constants(d: int) -> Tuple[int, int]:
    """(mul, shr) with x // d == (x * mul) >> (32 + shr) for 0 <= x < 2**31
    (CUTLASS's FastDivmod; the kernel takes x itself for d == 1)."""
    if not 1 <= d < MAX_ELEMENTS:
        raise ValueError(f"divisor {d} out of range")
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()          # 31 + ceil(log2 d)
    return -(-(1 << p) // d), p - 32


def leaf_plan(spec: LeafSpec, index: int = 0, tile_begin: int = 0
              ) -> LeafPlan:
    """Vector width, client chunks and tiles of one descriptor.

    V is the largest width up to 16 bytes that divides C where the channel
    axis is last (B == 1), else B, and keeps G, L, the output and (B == 1)
    the mask aligned: a vector's lanes then have consecutive channels of
    one mask row, read as one vector, or share one channel.  The N clients
    split into the fewest equal chunks of at most ``CLIENTS``."""
    a, c, b = spec.acb
    size = a * c * b
    if size >= MAX_ELEMENTS:
        raise ValueError(f"a descriptor of {size} elements: the merge "
                         f"kernel takes fewer than {MAX_ELEMENTS} "
                         f"(split_leaf cuts a larger leaf)")
    es = torch.empty((), dtype=spec.dtype).element_size()
    addrs = list(spec.addrs)
    if spec.mask_c != 1 and b == 1:
        addrs.append(spec.mask_addr)
    vec = _lib.vector_width_of(b if b > 1 else c, es,
                               [(p, es) for p in addrs])
    chunks = -(-spec.n // CLIENTS)
    chunk = -(-spec.n // chunks)
    return LeafPlan(index, vec, chunk, tile_begin,
                    -(-(size // vec) // THREADS) * chunks, spec)


def _aligned_step(count: int, unit: int) -> int:
    """``count`` rounded down to a multiple of the units that keep a
    piece boundary 16-byte aligned (``unit`` elements each), if any fit."""
    step = 16 // math.gcd(unit, 16)
    return count - count % step if count >= step else count


def split_leaf(acb: Tuple[int, int, int]) -> List[Piece]:
    """The descriptors of a client leaf (A, C, B): the whole leaf when it
    holds fewer than ``MAX_ELEMENTS`` elements; else runs of whole rows of
    A, each under the limit; else (a row alone reaches it) runs of whole
    channels of one row; else (one channel reaches it) runs of one
    channel.  Every element is covered once, in order."""
    a, c, b = acb
    limit = MAX_ELEMENTS - 1
    if a * c * b <= limit:
        return [Piece(0, acb, 0)]
    if c * b <= limit:
        rows = _aligned_step(limit // (c * b), c * b)
        return [Piece(a0 * c * b, (min(rows, a - a0), c, b), 0)
                for a0 in range(0, a, rows)]
    if b <= limit:
        chans = _aligned_step(limit // b, b)
        return [Piece(a0 * c * b + c0 * b, (1, min(chans, c - c0), b), c0)
                for a0 in range(a) for c0 in range(0, c, chans)]
    run = _aligned_step(limit, 1)
    return [Piece(a0 * c * b + c0 * b + b0, (1, 1, min(run, b - b0)), c0)
            for a0 in range(a) for c0 in range(c) for b0 in range(0, b, run)]


def _pieces(spec: LeafSpec) -> List[LeafSpec]:
    """``spec`` as the specs of its descriptors: itself, or for a leaf cut
    by :func:`split_leaf` one of a single client per piece, its G address
    moved to the piece, its L and output addresses to the client's piece,
    its mask to the client's row at the piece's first channel."""
    a, c, b = spec.acb
    pieces = split_leaf(spec.acb)
    if len(pieces) == 1:
        return [spec]
    es = torch.empty((), dtype=spec.dtype).element_size()
    g, l, out = spec.addrs
    return [spec._replace(
        n=1, acb=p.acb,
        addrs=(g + p.offset * es, l + (k * a * c * b + p.offset) * es,
               out + (k * a * c * b + p.offset) * es),
        mask_addr=spec.mask_addr + (k * spec.mask_c
                                    + (p.c0 if spec.mask_c != 1 else 0)) * es)
        for k in range(spec.n) for p in pieces]


def plan(specs: Sequence[LeafSpec]) -> List[Launch]:
    """The launches that merge ``specs``: the descriptors of each dtype's
    leaves (dtypes in the order they first appear; a leaf of 2**31
    elements or more takes several, :func:`split_leaf`), in order,
    ``MAX_LEAVES`` at a time and at most ``MAX_TILES`` tiles a launch.
    Empty leaves take no tiles and no launch."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, s in enumerate(specs):
        a, c, b = s.acb
        if s.n * a * c * b:
            by_dtype.setdefault(s.dtype, []).append(i)
    launches = []
    for dtype, idx in by_dtype.items():
        leaves, begin = [], 0
        for i in idx:
            for piece in _pieces(specs[i]):
                lp = leaf_plan(piece, i, begin)
                if len(leaves) == MAX_LEAVES or (
                        leaves and begin + lp.tiles > MAX_TILES):
                    launches.append(Launch(dtype, tuple(leaves), begin))
                    leaves, begin = [], 0
                    lp = lp._replace(tile_begin=0)
                leaves.append(lp)
                begin += lp.tiles
        launches.append(Launch(dtype, tuple(leaves), begin))
    return launches


def leaf_counts() -> Dict[int, int]:
    """Launches by the number of descriptors each took (its leaves; a
    leaf of 2**31 elements or more counts a descriptor per client and
    piece), since ``kernels.reset_launch_counts``."""
    return _lib.route_launches("masked_merge")


def _leaf_view(global_w: torch.Tensor, local_w: torch.Tensor,
               mask: torch.Tensor):
    """Check one leaf's operands -> ((A, C, B), mask_c)."""
    n = local_w.shape[0]
    if tuple(global_w.shape) != tuple(local_w.shape[1:]) or \
            mask.shape[0] != n:
        raise ValueError(f"global {tuple(global_w.shape)}, local "
                         f"{tuple(local_w.shape)} and mask "
                         f"{tuple(mask.shape)} do not fit")
    acb, mask_c = _lib.mask_view(local_w.shape[1:], mask.shape[1:])
    _lib.check_dtype("local_w", local_w, _lib.DTYPE_CODES)
    _lib.check_dtype("global_w", global_w, (local_w.dtype,))
    _lib.check_dtype("mask", mask, (local_w.dtype,))
    _lib.check_contiguous(global_w=global_w, local_w=local_w, mask=mask)
    return acb, mask_c


def masked_merge_many(global_ws: Sequence[torch.Tensor],
                      local_ws: Sequence[torch.Tensor],
                      masks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Eq. (5) for a group of client-stacked leaves.

    For each i: global_ws[i] (*leaf); local_ws[i] (N, *leaf); masks[i]
    channel-shaped (N, 1, ..., C, ..., 1) or (N, 1, ..., 1), all in one
    dtype, all leaves on one device.  Returns the (N, *leaf) merges in
    local_ws' dtypes.  On the card one launch merges up to MAX_LEAVES
    leaves of one dtype.
    """
    global_ws, local_ws, masks = list(global_ws), list(local_ws), list(masks)
    if not len(global_ws) == len(local_ws) == len(masks):
        raise ValueError(f"{len(global_ws)} globals, {len(local_ws)} locals "
                         f"and {len(masks)} masks")
    if not local_ws:
        return []
    views = [_leaf_view(g, l, m)
             for g, l, m in zip(global_ws, local_ws, masks)]
    dev = _lib.kernel_device(*global_ws, *local_ws, *masks)
    if dev == "cpu":
        return [masked_merge_ref(g.view(acb), l.view((l.shape[0],) + acb),
                                 m.view(m.shape[0], mask_c)).view(l.shape)
                for g, l, m, (acb, mask_c) in zip(global_ws, local_ws,
                                                  masks, views)]
    outs = [torch.empty_like(l) for l in local_ws]
    specs = [LeafSpec(l.dtype, l.shape[0], acb, mask_c,
                      (g.data_ptr(), l.data_ptr(), o.data_ptr()),
                      m.data_ptr())
             for g, l, m, o, (acb, mask_c) in zip(global_ws, local_ws, masks,
                                                  outs, views)]
    for launch in plan(specs):
        table = (ctypes.c_int64 * (FIELDS * len(launch.leaves)))()
        for row, lp in enumerate(launch.leaves):
            s = lp.spec
            a, c, b = s.acb
            table[row * FIELDS:(row + 1) * FIELDS] = [
                s.addrs[0], s.addrs[1], s.mask_addr, s.addrs[2], s.n, a, c,
                b, s.mask_c, lp.vec, lp.tile_begin, lp.chunk,
                *divmod_constants(c), *divmod_constants(b),
                *divmod_constants(-(-s.n // lp.chunk))]
        _lib.launch("masked_merge", "feddd_masked_merge_group", table,
                    len(launch.leaves), _lib.DTYPE_CODES[launch.dtype],
                    device=outs[0].device, route=len(launch.leaves))
    return outs


def masked_merge(global_w: torch.Tensor, local_w: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Eq. (5) for one client-stacked leaf: a group of one.

    global_w: (*leaf); local_w: (N, *leaf); mask: channel-shaped
    (N, 1, ..., C, ..., 1) or (N, 1, ..., 1), all in one dtype.
    Returns (N, *leaf) in local_w's dtype.
    """
    return masked_merge_many([global_w], [local_w], [mask])[0]
