"""Wrapper of the sparse aggregation kernel (``csrc/sparse_agg.cu``): the
Eq. (4) partials, and the mean mode that finishes Eq. (4) in the kernel.

Both modes take a channel-shaped mask (N, 1, ..., C, ..., 1), an all-ones
one (N, 1, ..., 1), or an elementwise mask shaped like the values (the
Pallas kernel's own contract; a ragged fleet's zero-padded canvas, whose
padded input channels no channel mask can describe).  Launches count by
mode and by mask: ``"mean"`` / ``"partials"`` for channel and all-ones
masks, ``"mean:elementwise"`` / ``"partials:elementwise"`` otherwise.

``select=True`` (either mode) makes a term whose mask is 0 add nothing to
the numerator, so a NaN or Inf on a masked-out entry stays out of Eq. (4):
the JAX package's compiled engine step, where XLA rewrites
``W * convert(mask)`` into a select (at the 1-D leaves of a step without
delivered prefixes; ``core/round_engine.py``).  Off, NaN * 0 stays NaN,
the literal Eq. (4).  :func:`select_counts` counts the launches with it."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.sparse_agg.ref import (masked_weighted_mean_ref,
                                                masked_weighted_sum_ref)

PARTIALS, MEAN = 0, 1               # the kernel's modes
MODES = ("partials", "mean")


ELEMENTWISE = ":elementwise"        # the route suffix of a per-element mask


def _leaf_view(stack_w: torch.Tensor, stack_m: torch.Tensor,
               weights: torch.Tensor):
    """Check the operands -> (device type, n, (a, c, b), mask_c); an
    elementwise mask has mask_c == a * c * b."""
    n = stack_w.shape[0]
    if stack_m.shape[0] != n or tuple(weights.shape) != (n,):
        raise ValueError(f"values {tuple(stack_w.shape)}, mask "
                         f"{tuple(stack_m.shape)} and weights "
                         f"{tuple(weights.shape)} disagree on N")
    acb, mask_c = _lib.mask_view(stack_w.shape[1:], stack_m.shape[1:],
                                 elementwise=True)
    _lib.check_dtype("stack_w", stack_w, _lib.DTYPE_CODES)
    _lib.check_dtype("stack_m", stack_m, (stack_w.dtype,))
    _lib.check_dtype("weights", weights, (torch.float32,))
    dev = _lib.kernel_device(stack_w, stack_m, weights)
    _lib.check_contiguous(stack_w=stack_w, stack_m=stack_m, weights=weights)
    return dev, n, acb, mask_c


def _elementwise(acb, mask_c) -> bool:
    a, c, b = acb
    return mask_c == a * c * b and a * b > 1


def _mask_rows(stack_m: torch.Tensor, acb, mask_c) -> torch.Tensor:
    """The mask as the plain version takes it: (N, C_m), or (N, A, C, B)
    for an elementwise one."""
    n = stack_m.shape[0]
    return (stack_m.view(n, *acb) if _elementwise(acb, mask_c)
            else stack_m.view(n, mask_c))


def _launch(mode, stack_w, stack_m, weights, gprev, out, den, acb,
            mask_c, select) -> None:
    a, c, b = acb
    # V <= 4 elements per access: the values, the outputs and gprev, and a
    # channel-last or elementwise mask's rows, all aligned to V
    vectors = [t for t in (out, den, gprev) if t is not None]
    if b == 1 and mask_c != 1:
        vectors.append(stack_m)
    vec = _lib.vector_width(c if b == 1 else b, stack_w, *vectors, most=4)
    _lib.launch("sparse_agg", "feddd_sparse_agg", stack_w.data_ptr(),
                stack_m.data_ptr(), weights.data_ptr(),
                None if gprev is None else gprev.data_ptr(), out.data_ptr(),
                None if den is None else den.data_ptr(), stack_w.shape[0], a,
                c, b, mask_c, vec, mode, int(bool(select)),
                _lib.DTYPE_CODES[stack_w.dtype], _lib.DTYPE_CODES[out.dtype],
                device=stack_w.device,
                route=MODES[mode] + (ELEMENTWISE if _elementwise(acb, mask_c)
                                     else ""))
    if select:
        _lib.count_flag("sparse_agg", "select")


ROUTES = MODES + tuple(m + ELEMENTWISE for m in MODES)


def route_counts() -> Dict[str, int]:
    """Launches by mode and mask since ``kernels.reset_launch_counts``:
    "partials" / "mean" with a channel or all-ones mask, and the same
    with the ":elementwise" suffix with a per-element mask."""
    return _lib.route_launches("sparse_agg", ROUTES)


def select_counts() -> Dict[str, int]:
    """Launches with ``select=True`` since
    ``kernels.reset_launch_counts``."""
    return {"select": _lib.flag_launches("sparse_agg", "select")}


def mode_counts() -> Dict[str, int]:
    """Launches by mode, whatever the mask, since
    ``kernels.reset_launch_counts``."""
    r = route_counts()
    return {m: r[m] + r[m + ELEMENTWISE] for m in MODES}


def masked_weighted_sum(stack_w: torch.Tensor, stack_m: torch.Tensor,
                        weights: torch.Tensor, select: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (4) partials of one client-stacked leaf.

    stack_w: (N, *leaf) values; stack_m: the channel-shaped mask
    (N, 1, ..., C, ..., 1), (N, 1, ..., 1) for full uploads, or an
    elementwise (N, *leaf) mask, in the values' dtype; weights: (N,)
    fp32; ``select``: masked-out terms add nothing (module docstring).
    Returns fp32 (num, den), each shaped like the leaf.
    """
    dev, n, (a, c, b), mask_c = _leaf_view(stack_w, stack_m, weights)
    leaf = stack_w.shape[1:]
    if dev == "cpu":
        num, den = masked_weighted_sum_ref(
            stack_w.view(n, a, c, b), _mask_rows(stack_m, (a, c, b), mask_c),
            weights, select)
        return num.reshape(leaf), den.reshape(leaf)
    num = torch.empty(leaf, dtype=torch.float32, device=stack_w.device)
    den = torch.empty(leaf, dtype=torch.float32, device=stack_w.device)
    _launch(PARTIALS, stack_w, stack_m, weights, None, num, den, (a, c, b),
            mask_c, select)
    return num, den


def masked_weighted_mean(stack_w: torch.Tensor, stack_m: torch.Tensor,
                         weights: torch.Tensor,
                         gprev: Optional[torch.Tensor] = None,
                         dtype: Optional[torch.dtype] = None,
                         select: bool = False) -> torch.Tensor:
    """Eq. (4) of one client-stacked leaf, finished: num / max(den, eps),
    and where no client uploaded a position (den <= eps) the previous
    global ``gprev`` (shaped like the leaf), in ``dtype`` (default: the
    values').  One launch; num and den never reach device memory.

    The operands and ``select`` are those of :func:`masked_weighted_sum`.
    A ``gprev`` in
    another dtype than ``dtype`` is cast to it first, which gives the same
    result as filling in fp32 and casting after.
    """
    dev, n, (a, c, b), mask_c = _leaf_view(stack_w, stack_m, weights)
    leaf = stack_w.shape[1:]
    dtype = stack_w.dtype if dtype is None else dtype
    if dtype not in _lib.DTYPE_CODES:
        raise TypeError(f"dtype {dtype}; expected one of "
                        f"{tuple(_lib.DTYPE_CODES)}")
    if gprev is not None:
        _lib.check_dtype("gprev", gprev, _lib.DTYPE_CODES)
        if gprev.shape != leaf:
            raise ValueError(f"gprev {tuple(gprev.shape)} is not shaped "
                             f"like the leaf {tuple(leaf)}")
        _lib.kernel_device(stack_w, gprev)
        _lib.check_contiguous(gprev=gprev)
    if dev == "cpu":
        return masked_weighted_mean_ref(
            stack_w.view(n, a, c, b), _mask_rows(stack_m, (a, c, b), mask_c),
            weights,
            None if gprev is None else gprev.view(a, c, b),
            dtype, select).reshape(leaf)
    if gprev is not None and gprev.dtype != dtype:
        gprev = gprev.to(dtype)
    out = torch.empty(leaf, dtype=dtype, device=stack_w.device)
    _launch(MEAN, stack_w, stack_m, weights, gprev, out, None, (a, c, b),
            mask_c, select)
    return out
