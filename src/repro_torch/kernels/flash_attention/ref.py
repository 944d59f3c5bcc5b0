"""Plain PyTorch version of the flash-attention kernel: dense causal /
sliding-window GQA attention with fp32 scores and softmax.

The counterpart of ``repro.kernels.flash_attention.ref.gqa_attention_ref``:
the (B, Hkv, G, Sq, Skv) scores are materialised in fp32 (scaled after
the dot), masked to ``NEG_INF`` and soft-maxed.  Memory grows as Sq*Skv,
so this is for checks: at B=1, H=32, S=8192 the scores alone take 8.6 GB;
``gqa_attention_ref_chunked`` holds one chunk of query rows at a time.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.3819763e38


def band_mask(sq: int, skv: int, causal: bool, window: int,
              device, q_offset: int = 0) -> torch.Tensor:
    """(sq, skv) boolean: query i (at position q_offset + i) attends key j
    (window 0 = unlimited)."""
    qi = torch.arange(q_offset, q_offset + sq, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    return mask


def valid_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Number of (query, key) pairs the mask lets through: the work an
    exact kernel must do (``band_mask(...).sum()`` without the matrix).

    Row i keeps the keys j in [0, skv) with j <= i (causal) and
    j >= i - window + 1 (window): ``clip(i + 1) - clip(i - window + 1)``
    with ``clip`` to [0, skv], summed in closed form."""
    def ramp(m: int) -> int:       # sum of clip(t, 0, skv) for t in [0, m]
        if m < 0:
            return 0
        if m <= skv:
            return m * (m + 1) // 2
        return skv * (skv + 1) // 2 + (m - skv) * skv

    def rows(a: int) -> int:       # sum of clip(i + a, 0, skv), i < sq
        return ramp(a + sq - 1) - ramp(a - 1)

    upper = rows(1) if causal else sq * skv
    lower = rows(1 - window) if window else 0
    return upper - lower


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, H, hd).

    ``q_offset`` is the position of q's first row in the sequence of k/v
    (the mask's row index), so a chunk of query rows gives those rows of
    the whole."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, hd).float()
    scores = torch.einsum("bqhgk,bshk->bhgqs", qg, k.float())
    scores.div_(math.sqrt(hd))
    mask = band_mask(sq, skv, causal, window, q.device, q_offset)
    scores.masked_fill_(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bhgqs,bshk->bqhgk", w, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def gqa_attention_ref_chunked(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0,
                              rows: int = 1024) -> torch.Tensor:
    """``gqa_attention_ref`` over chunks of ``rows`` query rows: one chunk's
    scores are in memory at a time (4.3 GB at B=1, H=32, Skv=32768).  A
    causal chunk reads the keys up to its last row only: the later ones are
    masked for all its rows."""
    out = torch.empty_like(q)
    for r0 in range(0, q.shape[1], rows):
        r1 = min(r0 + rows, q.shape[1])
        kv_end = min(r1, k.shape[1]) if causal else k.shape[1]
        out[:, r0:r1] = gqa_attention_ref(
            q[:, r0:r1], k[:, :kv_end], v[:, :kv_end], causal=causal,
            window=window, q_offset=r0)
    return out


def worst_row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over output rows (b, i, h) of max_d |got - want| / max_d |want|.

    The per-row check of the bf16 kernel, besides the elementwise 2e-2: a
    row that lost or gained a tile of keys moves by a large part of its own
    scale (~sqrt(tile / keys)), its bf16 rounding by a few ulps (~1/256).
    Rows whose ``want`` is all zero count their absolute error."""
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    return float((diff / torch.where(scale > 0, scale, 1.0)).max())
