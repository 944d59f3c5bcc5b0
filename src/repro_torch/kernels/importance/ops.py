"""Wrapper of the importance kernel (``csrc/importance.cu``)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.importance.ref import channel_importance_ref


def channel_importance_batched(w_old: torch.Tensor, w_new: torch.Tensor, *,
                               channel_axis: int = -1,
                               coverage: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Client-stacked Eq. (20)/(21): (N, *leaf) x2 -> (N, C) fp32.

    ``channel_axis`` indexes the un-stacked leaf.  The leaf is read in
    place as (N, A, C, B) around its channel axis.
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
    out = torch.empty((n, c), dtype=torch.float32, device=w_old.device)
    _lib.launch("importance", "feddd_importance", w_old.data_ptr(),
                w_new.data_ptr(),
                None if coverage is None else coverage.data_ptr(),
                out.data_ptr(), n, a, c, b, _lib.DTYPE_CODES[w_old.dtype])
    return out
