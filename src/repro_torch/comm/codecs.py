"""Sparse-set codecs for upload masks — who survived the dropout, in bytes.

The port's copy of ``repro.comm.codecs``.  FedDD masks are channel-granular:
per leaf the kept set is a subset of the C channels, so a sparse upload
ships, per leaf, an encoding of that subset plus the kept values:

* ``bitmask`` — a 4-byte kept-count header + ceil(C/8) packed bits;
* ``index``  — a 4-byte header + the kept channel indices, ascending,
  delta-encoded (gaps ``idx_k - idx_{k-1} - 1``) and varint-compressed
  (7 data bits a byte, MSB continuation);
* ``dense``  — the values-only idealization: no mask bytes at all (the
  default, the analytic accounting);
* ``auto``   — per leaf a 1-byte tag + the cheaper of bitmask and index.

The measured byte formulas (``mask_overhead_bytes*``) are integer
comparison sums in int32, no float log2: the client-stacked one runs as
torch operations on the masks' device, all leaves in one pass, the
per-client one in numpy.  The serialized encodings (``encode_mask`` /
``decode_mask``) are byte strings whose length equals the formula.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch import tree

CODECS = ("dense", "bitmask", "index", "auto")

# Per-leaf framing of the sparse codecs: a u32 kept-count header, plus a
# 1-byte codec tag when "auto" picks per leaf.
HEADER_BYTES = 4
AUTO_TAG_BYTES = 1

# value v takes 1 + sum(v >= 2^(7k)) varint bytes; channel gaps stay below
# 2^28, so four thresholds suffice and everything stays in int32
_VARINT_THRESHOLDS = (1 << 7, 1 << 14, 1 << 21, 1 << 28)


def varint_bytes(values):
    """Bytes to varint-encode each non-negative integer of ``values`` (a
    tensor or an array; int32 out)."""
    if isinstance(values, torch.Tensor):
        out = torch.ones_like(values, dtype=torch.int32)
        for t in _VARINT_THRESHOLDS:
            out = out + (values >= t).to(torch.int32)
        return out
    v = np.asarray(values)
    out = np.ones_like(v, dtype=np.int32)
    for t in _VARINT_THRESHOLDS:
        out = out + (v >= t).astype(np.int32)
    return out


def bitmask_bytes(num_channels: int) -> int:
    """Packed-bitmask payload bytes of a C-channel leaf (header excluded)."""
    return (int(num_channels) + 7) // 8


def _index_gaps(mask1d):
    """Delta gaps ``idx_k - idx_{k-1} - 1`` at kept positions, else 0, and
    the kept flags, of a 0/1 mask (..., C): the previous kept index is an
    exclusive running max of ``i if kept else -1``."""
    m = np.asarray(mask1d) > 0
    c = m.shape[-1]
    idx = np.arange(c, dtype=np.int32)
    marked = np.where(m, idx, np.int32(-1))
    incl = np.maximum.accumulate(marked, axis=-1)
    prev = np.concatenate([np.full(m.shape[:-1] + (1,), -1, np.int32),
                           incl[..., :-1]], axis=-1)
    return np.where(m, idx - prev - 1, 0).astype(np.int32), m


def index_bytes(mask1d) -> np.ndarray:
    """Delta+varint payload bytes of a 0/1 channel mask (..., C), header
    excluded; an empty mask costs 0."""
    gaps, m = _index_gaps(mask1d)
    return np.sum(np.where(m, varint_bytes(gaps), 0),
                  axis=-1).astype(np.int32)


def _leaf_overhead(m1d, num_channels: int, codec: str) -> np.ndarray:
    """Measured per-leaf mask overhead, int32 over the leading axes of the
    (..., C) channel mask ``m1d``, for one codec (dense: 0)."""
    lead = m1d.shape[:-1]
    if codec == "dense":
        return np.zeros(lead, np.int32)
    bm = HEADER_BYTES + bitmask_bytes(num_channels)
    if codec == "bitmask":
        return np.full(lead, bm, np.int32)
    ix = HEADER_BYTES + index_bytes(m1d)
    if codec == "index":
        return ix
    if codec == "auto":
        return AUTO_TAG_BYTES + np.minimum(ix, bm)
    raise ValueError(f"unknown sparse codec {codec!r}; one of {CODECS}")


@functools.lru_cache(maxsize=32)
def _stacked_layout(widths: Tuple[int, ...], device: torch.device):
    """Per column of the leaves' channel masks side by side: its global
    index, its leaf's first column minus 1 (int32), its leaf (int64); per
    leaf the bitmask codec's bytes with the header (int32)."""
    starts = np.cumsum((0,) + widths[:-1])
    leaf = np.repeat(np.arange(len(widths)), widths)
    return (torch.arange(sum(widths), dtype=torch.int32, device=device),
            torch.from_numpy((starts[leaf] - 1).astype(np.int32)).to(device),
            torch.from_numpy(leaf).to(device),
            torch.tensor([HEADER_BYTES + bitmask_bytes(c) for c in widths],
                         dtype=torch.int32, device=device))


def mask_overhead_bytes_stacked(masks, params_stacked, comm) -> torch.Tensor:
    """Measured mask overhead of each client, (N,) int32 on the masks'
    device.

    ``masks`` leaves are (N, 1, ..., C, ..., 1) (what
    ``selection.build_masks_batched`` returns); ``params_stacked`` gives
    N.  With ``comm.qbits == 8`` every leaf with a non-empty kept set adds
    its 4-byte scale.  All leaves go in one pass: their channel masks side
    by side, one running max for the index codec's gaps (a leaf's marks
    start at its first column minus 1, above every earlier leaf's), and
    per-leaf sums by ``index_add_``.
    """
    n = tree.leaves(params_stacked)[0].shape[0]
    m1ds = []
    for m in tree.leaves(masks):
        m1d = m.reshape(m.shape[0], -1)
        if m1d.shape[0] != n:    # a mask leaf without a client axis
            m1d = m1d.reshape(1, -1).expand(n, m1d.numel())
        m1ds.append(m1d)
    dev = m1ds[0].device
    widths = tuple(int(m.shape[1]) for m in m1ds)
    gidx, start, leaf, bm = _stacked_layout(widths, dev)
    kept = torch.cat(m1ds, dim=1) > 0                          # (N, W)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def per_leaf(values):
        return torch.zeros((n, len(widths)), dtype=torch.int32,
                           device=dev).index_add_(1, leaf, values)

    if comm.codec == "dense":
        oh = torch.zeros((n, len(widths)), dtype=torch.int32, device=dev)
    elif comm.codec == "bitmask":
        oh = bm.expand(n, -1)
    elif comm.codec in ("index", "auto"):
        incl = torch.cummax(torch.where(kept, gidx, start), dim=1).values
        prev = torch.maximum(torch.cat([start[:1].expand(n, 1),
                                        incl[:, :-1]], dim=1), start)
        gaps = torch.where(kept, gidx - prev - 1, zero)
        ix = HEADER_BYTES + per_leaf(torch.where(kept, varint_bytes(gaps),
                                                 zero))
        oh = ix if comm.codec == "index" else (
            AUTO_TAG_BYTES + torch.minimum(ix, bm))
    else:
        raise ValueError(f"unknown sparse codec {comm.codec!r}; one of "
                         f"{CODECS}")
    if comm.qbits == 8:
        oh = oh + 4 * (per_leaf(kept.to(torch.int32)) > 0).to(torch.int32)
    return oh.sum(dim=1, dtype=torch.int32)


def full_upload_overhead_bytes(spec, comm) -> int:
    """Measured overhead of a FULL (all-channels) upload, in closed form
    from a ``payload.WireSpec``: what ``mask_overhead_bytes`` gives for
    materialised all-ones masks (the engines' dense masks collapse the
    channel axis, so encoding them would undercount)."""
    total = 0
    for c, _ in spec.leaves:
        if comm.codec != "dense":
            bm = HEADER_BYTES + bitmask_bytes(c)
            ix = HEADER_BYTES + c
            if comm.codec == "bitmask":
                total += bm
            elif comm.codec == "index":
                total += ix
            else:                    # auto
                total += AUTO_TAG_BYTES + min(bm, ix)
        if comm.qbits == 8:
            total += 4               # per-leaf scale, kept set non-empty
    return total


def mask_overhead_bytes(masks, params, comm) -> int:
    """One client's measured overhead (un-stacked masks, any array or
    tensor leaves): the per-client rendering of
    :func:`mask_overhead_bytes_stacked`."""
    del params   # kept for symmetry with the stacked rendering
    total = 0
    for m in tree.leaves(masks):
        if isinstance(m, torch.Tensor):
            m = m.detach().float().cpu().numpy()
        m1d = np.asarray(m, np.float32).reshape(-1)
        oh = int(_leaf_overhead(m1d[None], int(m1d.shape[0]),
                                comm.codec)[0])
        if comm.qbits == 8 and int(np.sum(m1d > 0)) > 0:
            oh += 4
        total += oh
    return total


# ------------------------------------------------------------ wire bytes

def encode_mask(mask1d, codec: str) -> bytes:
    """Serialize a 0/1 channel mask; ``len(result)`` equals the measured
    formula (header + payload).  ``dense`` encodes to b"" (the receiver
    knows the mask)."""
    m = np.asarray(mask1d).reshape(-1) > 0
    header = np.uint32(int(np.sum(m))).tobytes()
    if codec == "dense":
        return b""
    if codec == "bitmask":
        return header + np.packbits(m).tobytes()
    if codec == "index":
        gaps, kept = _index_gaps(m.astype(np.int32)[None])
        out = bytearray(header)
        for g in gaps[0][kept[0]]:
            v = int(g)
            while True:
                b = v & 0x7F
                v >>= 7
                out.append(b | (0x80 if v else 0))
                if not v:
                    break
        return bytes(out)
    if codec == "auto":
        bm = encode_mask(m, "bitmask")
        ix = encode_mask(m, "index")
        tag, body = (1, bm) if len(bm) <= len(ix) else (2, ix)
        return bytes([tag]) + body
    raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")


def decode_mask(buf: bytes, num_channels: int, codec: str) -> np.ndarray:
    """Inverse of :func:`encode_mask` -> 0/1 float32 vector of length C.
    ``dense`` decodes to all-ones (a full upload), the only case its
    idealization is byte-accounted for."""
    if codec == "dense":
        return np.ones(num_channels, np.float32)
    if codec == "auto":
        inner = {1: "bitmask", 2: "index"}[buf[0]]
        return decode_mask(buf[1:], num_channels, inner)
    kept = int(np.frombuffer(buf[:4], np.uint32)[0])
    body = buf[4:]
    if codec == "bitmask":
        bits = np.unpackbits(np.frombuffer(body, np.uint8))[:num_channels]
        m = bits.astype(np.float32)
        if int(m.sum()) != kept:
            raise ValueError(f"bitmask holds {int(m.sum())} channels, its "
                             f"header says {kept}")
        return m
    if codec == "index":
        m = np.zeros(num_channels, np.float32)
        pos, prev = 0, -1
        for _ in range(kept):
            v, shift = 0, 0
            while True:
                b = body[pos]
                pos += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            prev = prev + 1 + v
            m[prev] = 1.0
        return m
    raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")
