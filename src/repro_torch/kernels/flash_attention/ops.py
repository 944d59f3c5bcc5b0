"""Wrapper of the flash-attention kernels: two CUDA routes, one function.

* ``sm90`` (``csrc/flash_attention_sm90.cu``): wgmma on the tensor cores,
  TMA loads; bf16 inputs at head dims 64, 128, 192 and 256 — every
  full-width config that reaches the kernel.
* ``fma`` (``csrc/flash_attention.cu``): fp32 FMA on the CUDA cores; fp32
  inputs at every head dim (exact to fp32 rounding), and bf16 at head dims
  16, 32, 48 and 96.

The choice is static, on dtype and head dim (``route``); a bf16 input the
``sm90`` route cannot read raises, it is never sent to the other route.

A ``meta`` input (the dry-run's abstract trace, asked for by name) gets
an empty output of the kernel's shape; a launch and a meta call report
the kernel's cost (:func:`cost`) to an active cost counter.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.ref import (gqa_attention_ref,
                                                     valid_pairs)

HEAD_DIMS = (16, 32, 48, 64, 96, 128, 192, 256)
SM90_HEAD_DIMS = (64, 128, 192, 256)
ROUTES = ("sm90", "fma")


def route(dtype: torch.dtype, hd: int, strides: Iterable[int],
          ptr_align: int) -> str:
    """The CUDA route of a call: ``"sm90"`` for bf16 at a head dim in
    ``SM90_HEAD_DIMS``, ``"fma"`` otherwise.

    ``strides``: the (B, S, H) strides of q, k and v in elements, over the
    dims of size > 1; ``ptr_align``: the largest power of two, up to 16,
    dividing every base pointer, in bytes.  The ``sm90`` route reads through
    the TMA, which needs those strides to be positive multiples of 8
    elements (16 bytes) and the pointers 16-byte aligned; a bf16 call that
    breaks either raises ``ValueError``.
    """
    if dtype != torch.bfloat16 or hd not in SM90_HEAD_DIMS:
        return "fma"
    bad = [s for s in strides if s <= 0 or s % 8]
    if bad or ptr_align < 16:
        raise ValueError(
            f"the bf16 tensor-core route reads q/k/v through the TMA: their "
            f"(B, S, H) strides must be positive multiples of 8 elements "
            f"(got {bad}) and their data 16-byte aligned (got {ptr_align}); "
            f"make the inputs contiguous")
    return "sm90"


def cost(b: int, sq: int, skv: int, h: int, hkv: int, hd: int, causal: bool,
         window: int, elem_bytes: int) -> Tuple[int, int]:
    """(flops, bytes) of one call: 4 * hd flops per unmasked (query, key)
    pair and head (q.k and p.v), and q, k, v read once and the output
    written once."""
    flops = 4 * b * h * hd * valid_pairs(sq, skv, bool(causal), int(window))
    nbytes = (2 * b * sq * h * hd + 2 * b * skv * hkv * hd) * elem_bytes
    return flops, nbytes


def route_counts() -> Dict[str, int]:
    """Launches by route since ``kernels.reset_launch_counts``."""
    return _lib.route_launches("flash_attention", ROUTES)


def _ptr_align(*tensors: torch.Tensor) -> int:
    align = 16
    for t in tensors:
        ptr = t.data_ptr()
        if ptr:
            align = min(align, ptr & -ptr)
    return align


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, H, hd) in q's
    dtype.  GQA: query head h reads kv head h // (H/Hkv); window 0 means
    unlimited.

    q/k/v are read in place through their strides (the head dim must have
    unit stride); no transpose copy is made.

    Forward only: the kernel writes through a raw pointer, invisible to
    autograd, and has no backward (nor has the JAX package's Pallas
    kernel).  With grad enabled and q, k or v requiring grad it raises,
    on every device, rather than return an output that carries no
    gradient; training takes ``models.attention._sdpa_chunked``.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: call it under "
            "torch.inference_mode()/no_grad() or with inputs that do not "
            "require grad (training routes to models.attention."
            "_sdpa_chunked)")
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
    if all(t.device.type == "meta" for t in (q, k, v)):
        out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
        _lib.report_cost("flash_attention", lambda: cost(
            b, sq, skv, h, hkv, hd, causal, window, q.element_size()))
        return out
    dev = _lib.kernel_device(q, k, v)
    if dev == "cpu":
        return gqa_attention_ref(q, k, v, causal=causal, window=window)
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds the grid's 65535")
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)
               if t.shape[i] > 1]
    which = route(q.dtype, hd, strides, _ptr_align(q, k, v))
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, h, hkv, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(bool(causal)), int(window))
    if which == "sm90":
        _lib.launch("flash_attention", "feddd_flash_attention_sm90", *args,
                    device=q.device, route="sm90")
    else:
        _lib.launch("flash_attention", "feddd_flash_attention", *args,
                    _lib.DTYPE_CODES[q.dtype], device=q.device, route="fma")
    _lib.report_cost("flash_attention", lambda: cost(
        b, sq, skv, h, hkv, hd, causal, window, q.element_size()))
    return out
