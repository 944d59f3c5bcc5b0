"""Plain PyTorch version of the client-batched SAME convolution kernels:
a loop over the clients, each pass an im2col product (``F.unfold`` /
``F.fold``), in the tensors' own dtype.

Layouts are those of ``kernels/conv/ops``: activations (N, B, C, H, W),
weights (N, O, C, k, k), N clients, odd k, zero padding (k - 1) / 2.

  fprop  out[n, b, o, y, x] = sum_{c, ky, kx} x[n, b, c, y + ky - p,
                                  x + kx - p] * w[n, o, c, ky, kx]
  dgrad  the gradient of fprop with respect to x, for an output
         gradient g (N, B, O, H, W)
  wgrad  the gradient of fprop with respect to w
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad(w: torch.Tensor) -> int:
    return (w.shape[-1] - 1) // 2


def conv_fprop_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, B, C, H, W), w (N, O, C, k, k) -> (N, B, O, H, W)."""
    k, p = w.shape[-1], _pad(w)
    b, _, h, wd = x.shape[1:]
    outs = []
    for xi, wi in zip(x, w):
        cols = F.unfold(xi, k, padding=p)                # (B, C k k, HW)
        outs.append((wi.reshape(wi.shape[0], -1) @ cols).view(
            b, wi.shape[0], h, wd))
    return torch.stack(outs)


def conv_dgrad_ref(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g (N, B, O, H, W), w (N, O, C, k, k) -> (N, B, C, H, W)."""
    k, p = w.shape[-1], _pad(w)
    b, o, h, wd = g.shape[1:]
    outs = []
    for gi, wi in zip(g, w):
        cols = wi.reshape(o, -1).t() @ gi.reshape(b, o, h * wd)
        outs.append(F.fold(cols, (h, wd), k, padding=p))
    return torch.stack(outs)


def conv_wgrad_ref(x: torch.Tensor, g: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """x (N, B, C, H, W), g (N, B, O, H, W) -> (N, O, C, k, k)."""
    p = (k - 1) // 2
    b, c = x.shape[1:3]
    o = g.shape[2]
    outs = []
    for xi, gi in zip(x, g):
        cols = F.unfold(xi, k, padding=p)                # (B, C k k, HW)
        gw = (gi.reshape(b, o, -1) @ cols.transpose(1, 2)).sum(0)
        outs.append(gw.view(o, c, k, k))
    return torch.stack(outs)
