"""Parameter importance indices — FedDD §4.2, Eq. (20)/(21).

    I_n^k   = || dW * (W + dW) / W ||_(k)          (homogeneous)
    I~_n^k  = I_n^k / CR(k)                        (heterogeneous)

where the norm groups parameters by channel (``channel_axis`` of each
leaf; the FL parameters store channels last) and ``CR(k)`` is the
coverage rate of channel ``k``.  The FedDD score runs through the
importance kernel (:mod:`repro_torch.kernels.importance`); the ablation
scores of §6.2 are plain tensor code.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.importance import ops as imp_ops


def channel_importance_batched(w_old: torch.Tensor, w_new: torch.Tensor, *,
                               channel_axis: int = -1,
                               coverage: Optional[torch.Tensor] = None,
                               per_client_split: bool = False
                               ) -> torch.Tensor:
    """Eq. (20)/(21) over a leading client axis: (N, *leaf) -> (N, C) fp32
    (``per_client_split``: the kernel's split plan, see its wrapper)."""
    return imp_ops.channel_importance_batched(
        w_old, w_new, channel_axis=channel_axis, coverage=coverage,
        per_client_split=per_client_split)


def channel_importance(w_old: torch.Tensor, w_new: torch.Tensor, *,
                       channel_axis: int = -1,
                       coverage: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """One client's Eq. (20)/(21): (*leaf) x2 -> (C,) fp32."""
    return channel_importance_batched(
        w_old.unsqueeze(0), w_new.unsqueeze(0), channel_axis=channel_axis,
        coverage=coverage)[0]


def _leaf_axes(ndim: int, channel_axis: int):
    """Reduction axes of a (N, *leaf) stacked tensor: everything except the
    client axis (0) and the channel axis (shifted by the client axis)."""
    ax = channel_axis % (ndim - 1) + 1
    return tuple(a for a in range(1, ndim) if a != ax)


def _channel_norm(x: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """sqrt of the sum of squares over every axis but clients and channels
    (none for a 1-D leaf: torch reads ``sum(dim=())`` as a full sum)."""
    axes = _leaf_axes(x.ndim, channel_axis)
    sq = x * x
    return torch.sqrt(sq.sum(dim=axes) if axes else sq)


def channel_score_max_batched(w_old: torch.Tensor, w_new: torch.Tensor, *,
                              channel_axis: int = -1) -> torch.Tensor:
    """'max selection': rank channels by parameter magnitude |W+dW|."""
    del w_old
    return _channel_norm(w_new, channel_axis)


def channel_score_delta_batched(w_old: torch.Tensor, w_new: torch.Tensor, *,
                                channel_axis: int = -1) -> torch.Tensor:
    """'delta selection' (Aji & Heafield): rank channels by |dW|."""
    return _channel_norm(w_new - w_old, channel_axis)


def channel_score_ordered(num_channels: int,
                          device: Optional[torch.device] = None
                          ) -> torch.Tensor:
    """'ordered selection' (FjORD-style): channel 0 always most important."""
    return torch.arange(num_channels, 0, -1, device=device).float()
