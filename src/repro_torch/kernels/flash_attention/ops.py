"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.ref import gqa_attention_ref

HEAD_DIMS = (16, 32, 48, 64, 96, 128, 192, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, H, hd) in q's
    dtype.  GQA: query head h reads kv head h // (H/Hkv); window 0 means
    unlimited.

    q/k/v are read in place through their strides (the head dim must have
    unit stride); no transpose copy is made.
    """
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, Sq, H, hd) and k/v (B, Skv, Hkv, hd) "
                         f"of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    if hkv == 0 or h % hkv != 0:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} kv "
                         f"heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported; one of {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    _lib.check_dtype("q", q, _lib.DTYPE_CODES)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride over the head "
                             f"dim")
    dev = _lib.kernel_device(q, k, v)
    if dev == "cpu":
        return gqa_attention_ref(q, k, v, causal=causal, window=window)
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds the grid's 65535")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    _lib.launch("flash_attention", "feddd_flash_attention", q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv, h,
                hkv, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                int(bool(causal)), int(window), _lib.DTYPE_CODES[q.dtype])
    return out
