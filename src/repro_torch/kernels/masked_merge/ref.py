"""Plain PyTorch version of the masked merge kernel (FedDD Eq. (5)):

out[n] = G * M[n] + L[n] * (1 - M[n]),   M a per-channel mask broadcast
over the fan-in, computed in fp32 and stored in L's dtype.
"""

from __future__ import annotations

import torch


def masked_merge_ref(global_w: torch.Tensor, local_w: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """global_w: (A, C, B); local_w: (N, A, C, B); mask: (N, C_m)."""
    n = local_w.shape[0]
    m = mask.float().view(n, 1, -1, 1)
    out = global_w.float()[None] * m + local_w.float() * (1.0 - m)
    return out.to(local_w.dtype)
