"""Plain PyTorch version of the importance kernel (FedDD Eq. (20)/(21)).

score[n, c] = sqrt( sum_{a,b} |dW * (W + dW) / W|^2 ) / max(cov[c], eps)

with dW = W_new - W_old, an epsilon-guarded division, fp32 arithmetic.
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-8


def channel_importance_ref(w_old: torch.Tensor, w_new: torch.Tensor,
                           coverage: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """w_old/w_new: (N, A, C, B); coverage: (C,) or None -> (N, C) fp32."""
    wo = w_old.float()
    wn = w_new.float()
    dw = wn - wo
    signed_eps = torch.where(wo < 0, -EPS, EPS).to(torch.float32)
    denom = torch.where(wo.abs() < EPS, signed_eps, wo)
    imp = (dw * wn / denom).abs()
    score = torch.sqrt((imp * imp).sum(dim=(1, 3)))
    if coverage is not None:
        score = score / torch.clamp(coverage.float(), min=EPS)
    return score
