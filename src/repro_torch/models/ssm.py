"""Mamba (selective SSM) block, used by the jamba hybrid architecture.

The counterpart of ``repro.models.ssm``.  Training and prefill run a
*chunked* selective scan: a Python loop over sequence chunks of
``CHUNK`` carries the (B, d_inner, d_state) fp32 SSM state (the JAX
package's outer ``lax.scan``); within a chunk a log-depth Hillis-Steele
scan over the chunk axis computes the recurrence ``h_t = a_t * h_{t-1} +
bx_t`` with the JAX package's combine ``(a_l * a_r, a_r * b_l + b_r)``
(where it runs ``lax.associative_scan``).  One chunk's ``a_bar``/``bx``
are (B, chunk, d_inner, d_state) fp32, 268 MB at jamba's full width and
chunk 256, where the whole sequence at once would be 8.6 GB a tensor at
8192 tokens.  The summation order differs from XLA's, so the port meets
the JAX package within a tolerance, not bit for bit.

The last chunk is not padded: the JAX package pads it with ``dt = 0``
(``a_bar = 1``, ``bx = 0``), which changes no output before the pad, and
the carry out of the last chunk is not used.

Decode is the exact single-step recurrence with a rolling conv window.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

CHUNK = 256


def d_inner(cfg: ModelConfig) -> int:
    return cfg.mamba.expand * cfg.d_model


def dt_rank(cfg: ModelConfig) -> int:
    return cfg.mamba.dt_rank or max(1, math.ceil(cfg.d_model / 16))


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype,
               lead=()) -> dict:
    """``a_log``, ``dt_bias`` and ``d_skip`` are fp32 whatever ``dtype``
    is, as in the JAX package."""
    m = cfg.mamba
    d, di, ds, dr = cfg.d_model, d_inner(cfg), m.d_state, dt_rank(cfg)
    lead = tuple(lead)
    dev = gen.device

    def dense(d_in, d_out):
        return layers.init_dense(gen, d_in, d_out, dtype, lead=lead)["kernel"]

    # S4D-real initialisation of A
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(
        lead + (di, ds))
    # softplus-inverse of U(1e-3, 1e-1)
    u = torch.rand(lead + (di,), generator=gen, device=dev,
                   dtype=torch.float32) * (1e-1 - 1e-3) + 1e-3
    return {
        "in_proj": dense(d, 2 * di),
        "conv_w": layers.normal(gen, lead + (m.d_conv, di),
                                1.0 / math.sqrt(m.d_conv), dtype),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "x_proj": dense(di, dr + 2 * ds),
        "dt_proj": dense(dr, di),
        "dt_bias": torch.log(torch.expm1(u)),
        "a_log": torch.log(a),
        "d_skip": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "out_proj": dense(di, d),
    }


class MambaState(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, d_inner) rolling inputs, model dtype
    ssm: torch.Tensor     # (B, d_inner, d_state) fp32

    @staticmethod
    def zeros(b: int, cfg: ModelConfig, dtype, device,
              lead=()) -> "MambaState":
        lead = tuple(lead)
        return MambaState(
            conv=torch.zeros(lead + (b, cfg.mamba.d_conv - 1, d_inner(cfg)),
                             dtype=dtype, device=device),
            ssm=torch.zeros(lead + (b, d_inner(cfg), cfg.mamba.d_state),
                            dtype=torch.float32, device=device))


def _ssm_params(p, cfg: ModelConfig, u: torch.Tensor):
    """u: (..., di) conv output -> (dt (..., di), B (..., ds), C (..., ds)),
    all fp32."""
    dr, ds = dt_rank(cfg), cfg.mamba.d_state
    proj = torch.matmul(u, p["x_proj"].to(u.dtype))
    dt_in, b, c = (proj[..., :dr], proj[..., dr:dr + ds],
                   proj[..., dr + ds:])
    dt = torch.matmul(dt_in, p["dt_proj"].to(u.dtype))
    dt = layers.softplus(dt.float() + p["dt_bias"].float())
    return dt, b.float(), c.float()


def _causal_conv(p, cfg: ModelConfig, x: torch.Tensor,
                 prefix: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq.  x: (B, S, di); prefix (B, dc-1, di)."""
    dc = cfg.mamba.d_conv
    s = x.shape[1]
    xp = torch.cat([prefix.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + s, :] * p["conv_w"][i].to(x.dtype)
              for i in range(dc))
    return F.silu(out + p["conv_b"].to(x.dtype))


def _scan_chunk(carry: torch.Tensor, a_bar: torch.Tensor, bx: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = a_t * h_{t-1} + bx_t`` within a chunk, in
    ceil(log2(Q)) Hillis-Steele passes: pass ``d`` combines element
    ``t - d`` (left) into ``t`` (right) as ``(a_l * a_r, a_r * b_l +
    b_r)``.  Out of place, so autograd can differentiate it.

    a_bar/bx: (B, Q, di, ds) fp32; carry: (B, di, ds).
    Returns (new_carry, h (B, Q, di, ds)).
    """
    a, h = a_bar, bx
    q = a.shape[1]
    d = 1
    while d < q:
        h = torch.cat([h[:, :d], torch.addcmul(h[:, d:], a[:, d:],
                                               h[:, :-d])], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    h = h + a * carry[:, None]
    return h[:, -1], h


def mamba_forward(p, cfg: ModelConfig, x: torch.Tensor,
                  chunk: int = CHUNK) -> torch.Tensor:
    """Training/prefill.  x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    di, ds = d_inner(cfg), cfg.mamba.d_state
    dt_ = x.dtype
    xz = torch.matmul(x, p["in_proj"].to(dt_))
    xs, z = xz[..., :di], xz[..., di:]
    prefix = torch.zeros((b, cfg.mamba.d_conv - 1, di), dtype=dt_,
                         device=x.device)
    u = _causal_conv(p, cfg, xs, prefix)
    dt, bmat, cmat = _ssm_params(p, cfg, u)
    a = -torch.exp(p["a_log"])                                 # (di, ds)
    uf = u.float()
    q = max(1, min(chunk, s))
    h = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, q):
        dt_c, u_c = dt[:, c0:c0 + q], uf[:, c0:c0 + q]
        # discretise: a_bar = exp(dt * A); bx = dt * B * u
        a_bar = torch.exp(dt_c[..., None] * a)                 # (B,Q,di,ds)
        bx = (dt_c * u_c)[..., None] * bmat[:, c0:c0 + q, None, :]
        h, hs = _scan_chunk(h, a_bar, bx)
        del a_bar, bx
        ys.append(torch.matmul(hs, cmat[:, c0:c0 + q, :, None])[..., 0])
        del hs
    y = torch.cat(ys, dim=1) + uf * p["d_skip"]
    y = y.to(dt_) * F.silu(z)
    return torch.matmul(y, p["out_proj"].to(dt_))


def mamba_decode(p, cfg: ModelConfig, x: torch.Tensor, state: MambaState
                 ) -> Tuple[torch.Tensor, MambaState]:
    """One token.  x: (B, 1, D) -> ((B, 1, D), the new state: fresh
    tensors, ``state`` untouched)."""
    di = d_inner(cfg)
    dt_ = x.dtype
    xz = torch.matmul(x, p["in_proj"].to(dt_))
    xs, z = xz[..., :di], xz[..., di:]                         # (B,1,di)
    window = torch.cat([state.conv.to(dt_), xs], dim=1)
    u = sum(window[:, i, :] * p["conv_w"][i].to(dt_)
            for i in range(cfg.mamba.d_conv))
    u = F.silu(u + p["conv_b"].to(dt_))                        # (B, di)
    dt, bmat, cmat = _ssm_params(p, cfg, u)
    a = -torch.exp(p["a_log"])
    a_bar = torch.exp(dt[..., None] * a)                       # (B,di,ds)
    uf = u.float()
    bx = (dt * uf)[..., None] * bmat[:, None, :]
    h = a_bar * state.ssm + bx
    y = torch.matmul(h, cmat[..., None])[..., 0] + uf * p["d_skip"]
    y = y.to(dt_) * F.silu(z[:, 0])
    out = torch.matmul(y, p["out_proj"].to(dt_))
    return out[:, None, :], MambaState(conv=window[:, 1:], ssm=h)
