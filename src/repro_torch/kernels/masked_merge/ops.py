"""Wrapper of the masked merge kernel (``csrc/masked_merge.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.masked_merge.ref import masked_merge_ref


def masked_merge(global_w: torch.Tensor, local_w: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Eq. (5) for one client-stacked leaf.

    global_w: (*leaf); local_w: (N, *leaf); mask: channel-shaped
    (N, 1, ..., C, ..., 1) or (N, 1, ..., 1), all in one dtype.
    Returns (N, *leaf) in local_w's dtype.
    """
    n = local_w.shape[0]
    leaf = local_w.shape[1:]
    if tuple(global_w.shape) != tuple(leaf) or mask.shape[0] != n:
        raise ValueError(f"global {tuple(global_w.shape)}, local "
                         f"{tuple(local_w.shape)} and mask "
                         f"{tuple(mask.shape)} do not fit")
    (a, c, b), mask_c = _lib.mask_view(leaf, mask.shape[1:])
    _lib.check_dtype("local_w", local_w, _lib.DTYPE_CODES)
    _lib.check_dtype("global_w", global_w, (local_w.dtype,))
    _lib.check_dtype("mask", mask, (local_w.dtype,))
    dev = _lib.kernel_device(global_w, local_w, mask)
    _lib.check_contiguous(global_w=global_w, local_w=local_w, mask=mask)
    if dev == "cpu":
        return masked_merge_ref(global_w.view(a, c, b),
                                local_w.view(n, a, c, b),
                                mask.view(n, mask_c)).view(local_w.shape)
    out = torch.empty_like(local_w)
    _lib.launch("masked_merge", "feddd_masked_merge", global_w.data_ptr(),
                local_w.data_ptr(), mask.data_ptr(), out.data_ptr(), n, a, c,
                b, mask_c, _lib.DTYPE_CODES[local_w.dtype])
    return out
