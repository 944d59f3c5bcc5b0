"""Wrapper of the sparse aggregation kernel (``csrc/sparse_agg.cu``)."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.sparse_agg.ref import masked_weighted_sum_ref


def masked_weighted_sum(stack_w: torch.Tensor, stack_m: torch.Tensor,
                        weights: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (4) partials of one client-stacked leaf.

    stack_w: (N, *leaf) values; stack_m: the channel-shaped mask
    (N, 1, ..., C, ..., 1), or (N, 1, ..., 1) for full uploads, in the
    values' dtype; weights: (N,) fp32.  Returns fp32 (num, den), each
    shaped like the leaf.
    """
    n = stack_w.shape[0]
    leaf = stack_w.shape[1:]
    if stack_m.shape[0] != n or tuple(weights.shape) != (n,):
        raise ValueError(f"values {tuple(stack_w.shape)}, mask "
                         f"{tuple(stack_m.shape)} and weights "
                         f"{tuple(weights.shape)} disagree on N")
    (a, c, b), mask_c = _lib.mask_view(leaf, stack_m.shape[1:])
    _lib.check_dtype("stack_w", stack_w, _lib.DTYPE_CODES)
    _lib.check_dtype("stack_m", stack_m, (stack_w.dtype,))
    _lib.check_dtype("weights", weights, (torch.float32,))
    dev = _lib.kernel_device(stack_w, stack_m, weights)
    _lib.check_contiguous(stack_w=stack_w, stack_m=stack_m, weights=weights)
    if dev == "cpu":
        num, den = masked_weighted_sum_ref(stack_w.view(n, a, c, b),
                                           stack_m.view(n, mask_c), weights)
        return num.reshape(leaf), den.reshape(leaf)
    num = torch.empty(leaf, dtype=torch.float32, device=stack_w.device)
    den = torch.empty(leaf, dtype=torch.float32, device=stack_w.device)
    _lib.launch("sparse_agg", "feddd_sparse_agg", stack_w.data_ptr(),
                stack_m.data_ptr(), weights.data_ptr(), num.data_ptr(),
                den.data_ptr(), n, a, c, b, mask_c,
                _lib.DTYPE_CODES[stack_w.dtype])
    return num, den
