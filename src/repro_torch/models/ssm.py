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

On a ``(data, model)`` mesh (``mamba_forward_shard``,
``mamba_decode_shard``) each ``model`` shard runs its block of the inner
channels: the conv, ``dt_proj``, the scan and the state are per channel;
``x_proj``'s contraction over the channels is summed over ``model``
before ``dt_proj`` and the softplus, and ``out_proj``'s partial after.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

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


def _x_proj(p, u: torch.Tensor) -> torch.Tensor:
    """u: (..., di) conv output -> (..., dt_rank + 2 d_state): the
    ``x_proj`` contraction over the inner channels (a partial sum over
    ``model`` on a shard)."""
    return torch.matmul(u, p["x_proj"].to(u.dtype))


def _dt_bc(p, cfg: ModelConfig, proj: torch.Tensor):
    """The whole ``x_proj`` output -> (dt (..., di), B (..., ds), C (...,
    ds)), all fp32: ``dt_proj`` and the softplus on the channels of
    ``p``."""
    dr, ds = dt_rank(cfg), cfg.mamba.d_state
    dt_in, b, c = (proj[..., :dr], proj[..., dr:dr + ds],
                   proj[..., dr + ds:])
    dt = torch.matmul(dt_in, p["dt_proj"].to(proj.dtype))
    dt = layers.softplus(dt.float() + p["dt_bias"].float())
    return dt, b.float(), c.float()


def _ssm_params(p, cfg: ModelConfig, u: torch.Tensor):
    """u: (..., di) conv output -> (dt (..., di), B (..., ds), C (..., ds)),
    all fp32."""
    return _dt_bc(p, cfg, _x_proj(p, u))


def _in_proj(p, x: torch.Tensor):
    """x (..., D) -> the (x, z) halves of ``in_proj``: its first and second
    halves of columns (a shard reads its channels of each)."""
    xz = torch.matmul(x, p["in_proj"].to(x.dtype))
    di = xz.shape[-1] // 2
    return xz[..., :di], xz[..., di:]


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


def _scan(p, u: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
          cmat: torch.Tensor, chunk: int) -> torch.Tensor:
    """The chunked selective scan over the channels of ``p``, plus the
    skip: (B, S, di) fp32."""
    b, s, di = u.shape
    ds = bmat.shape[-1]
    a = -torch.exp(p["a_log"])                                 # (di, ds)
    uf = u.float()
    q = max(1, min(chunk, s))
    h = torch.zeros((b, di, ds), dtype=torch.float32, device=u.device)
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
    return torch.cat(ys, dim=1) + uf * p["d_skip"]


def _out(p, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The silu(z) gate and ``out_proj`` (a partial sum over ``model`` on
    a shard)."""
    y = y.to(z.dtype) * F.silu(z)
    return torch.matmul(y, p["out_proj"].to(z.dtype))


def _prefix(cfg: ModelConfig, xs: torch.Tensor) -> torch.Tensor:
    return torch.zeros((xs.shape[0], cfg.mamba.d_conv - 1, xs.shape[-1]),
                       dtype=xs.dtype, device=xs.device)


def mamba_forward(p, cfg: ModelConfig, x: torch.Tensor,
                  chunk: int = CHUNK) -> torch.Tensor:
    """Training/prefill.  x: (B, S, D) -> (B, S, D)."""
    xs, z = _in_proj(p, x)
    u = _causal_conv(p, cfg, xs, _prefix(cfg, xs))
    dt, bmat, cmat = _ssm_params(p, cfg, u)
    return _out(p, _scan(p, u, dt, bmat, cmat, chunk), z)


def _conv_step(p, cfg: ModelConfig, xs: torch.Tensor, state: MambaState):
    """One token's conv: (u (B, di), the new conv window)."""
    dt_ = xs.dtype
    window = torch.cat([state.conv.to(dt_), xs], dim=1)
    u = sum(window[:, i, :] * p["conv_w"][i].to(dt_)
            for i in range(cfg.mamba.d_conv))
    return F.silu(u + p["conv_b"].to(dt_)), window[:, 1:]


def _ssm_step(p, u: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
              cmat: torch.Tensor, ssm: torch.Tensor):
    """One token's recurrence: (y (B, di) fp32 with the skip, the new
    SSM state)."""
    a = -torch.exp(p["a_log"])
    a_bar = torch.exp(dt[..., None] * a)                       # (B,di,ds)
    uf = u.float()
    bx = (dt * uf)[..., None] * bmat[:, None, :]
    h = a_bar * ssm + bx
    y = torch.matmul(h, cmat[..., None])[..., 0] + uf * p["d_skip"]
    return y, h


def mamba_decode(p, cfg: ModelConfig, x: torch.Tensor, state: MambaState
                 ) -> Tuple[torch.Tensor, MambaState]:
    """One token.  x: (B, 1, D) -> ((B, 1, D), the new state: fresh
    tensors, ``state`` untouched)."""
    xs, z = _in_proj(p, x)                                     # (B,1,di)
    u, conv = _conv_step(p, cfg, xs, state)                    # (B, di)
    dt, bmat, cmat = _ssm_params(p, cfg, u)
    y, h = _ssm_step(p, u, dt, bmat, cmat, state.ssm)
    return _out(p, y, z[:, 0])[:, None, :], MambaState(conv=conv, ssm=h)


# ------------------------------------------------------------ on a mesh ----

def mamba_forward_shard(ps, cfg: ModelConfig, xs, psum,
                        chunk: int = CHUNK) -> List[torch.Tensor]:
    """Every ``model`` shard's Mamba forward on its inner channels: device
    ``k`` computes with ``ps[k]`` (its channels of every ``inner`` leaf,
    ``in_proj`` read as its columns of ``x`` then of ``z``) on its
    (B_k, S, D) input ``xs[k]``.  The conv, ``dt_proj``, the scan and the
    state are per channel; ``x_proj``'s contraction over the channels is
    summed by ``psum`` (a list of every device's partials -> the sums
    over ``model``; the identity where the channels are not cut) before
    ``dt_proj`` and the softplus.  Returns each device's ``out_proj``
    partial, for the caller to sum as ``psum`` does."""
    pre = []
    for p, x in zip(ps, xs):
        xs_, z = _in_proj(p, x)
        pre.append((_causal_conv(p, cfg, xs_, _prefix(cfg, xs_)), z))
    proj = psum([_x_proj(p, u) for p, (u, _) in zip(ps, pre)])
    out = []
    for p, (u, z), pr in zip(ps, pre, proj):
        dt, bmat, cmat = _dt_bc(p, cfg, pr)
        out.append(_out(p, _scan(p, u, dt, bmat, cmat, chunk), z))
    return out


def mamba_decode_shard(ps, cfg: ModelConfig, xs, states, psum
                       ) -> Tuple[List[torch.Tensor], List[MambaState]]:
    """One decode step of every shard on its block of the state (its
    channels): :func:`mamba_forward_shard`'s split.  Returns (each
    device's ``out_proj`` partial (B_k, 1, D), its new state)."""
    pre = []
    for p, x, st in zip(ps, xs, states):
        xs_, z = _in_proj(p, x)
        u, conv = _conv_step(p, cfg, xs_, st)
        pre.append((u, z, conv))
    proj = psum([_x_proj(p, u) for p, (u, _, _) in zip(ps, pre)])
    out, new = [], []
    for p, (u, z, conv), pr, st in zip(ps, pre, proj, states):
        dt, bmat, cmat = _dt_bc(p, cfg, pr)
        y, h = _ssm_step(p, u, dt, bmat, cmat, st.ssm)
        out.append(_out(p, y, z[:, 0])[:, None, :])
        new.append(MambaState(conv=conv, ssm=h))
    return out, new
