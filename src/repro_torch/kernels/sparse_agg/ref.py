"""Plain PyTorch version of the sparse aggregation kernel (FedDD Eq. (4)).

num[a,c,b] = sum_n (W[n,a,c,b] * M[n,c]) * w_n
den[a,c,b] = sum_n  M[n,c] * w_n
mean       = where(den > eps, num / max(den, eps), gprev)   (mean mode)

With ``select``, a term whose mask is 0 adds nothing to num: W is read
through ``where(M != 0, W, 0)``, so a NaN or Inf on a masked-out entry
does not reach the sum (the JAX package's compiled engine step, where XLA
turns ``W * convert(mask)`` into a select); without it NaN * 0 stays NaN.

The mask is channel-shaped, (N, C_m) with C_m == C or 1 (all-ones masks),
or elementwise, (N, A, C, B) like the values (M[n,a,c,b] in place of
M[n,c]: a ragged fleet's zero-padded canvas).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-12


def masked_weighted_sum_ref(stack_w: torch.Tensor, stack_m: torch.Tensor,
                            weights: torch.Tensor, select: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """stack_w: (N, A, C, B); stack_m: (N, C_m) or (N, A, C, B);
    weights: (N,).

    Returns fp32 (num, den), each (A, C, B).
    """
    n = stack_w.shape[0]
    m = stack_m.float()
    if m.ndim == 2:
        m = m.view(n, 1, -1, 1)
    wts = weights.float().view(n, 1, 1, 1)
    vals = stack_w.float()
    if select:
        vals = torch.where(m != 0, vals, 0.0)
    num = (vals * m * wts).sum(0)
    den = (m * wts).expand(stack_w.shape).sum(0)
    return num, den


def finish_masked_mean(num: torch.Tensor, den: torch.Tensor,
                       gprev: Optional[torch.Tensor],
                       dtype: torch.dtype) -> torch.Tensor:
    """Eq. (4) division + previous-global fill over reduced (num, den)."""
    agg = num / torch.clamp(den, min=EPS)
    if gprev is not None:
        agg = torch.where(den > EPS, agg, gprev.float())
    return agg.to(dtype)


def masked_weighted_mean_ref(stack_w: torch.Tensor, stack_m: torch.Tensor,
                             weights: torch.Tensor,
                             gprev: Optional[torch.Tensor],
                             dtype: torch.dtype,
                             select: bool = False) -> torch.Tensor:
    """The mean mode: ``finish_masked_mean`` over the partials, (A, C, B)
    in ``dtype`` (gprev, where given, shaped like the partials)."""
    num, den = masked_weighted_sum_ref(stack_w, stack_m, weights, select)
    return finish_masked_mean(num, den, gprev, dtype)
