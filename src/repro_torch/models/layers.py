"""Basic layers: norms, dense projections, embeddings, rotary and
sinusoidal position embeddings.

The counterpart of ``repro.models.layers``: parameters are plain dicts of
tensors with the JAX package's names, shapes and dtypes, and ``apply``
logic is free functions.  Every ``init_*`` draws from an explicit
``torch.Generator`` (on the device the tensors are made on) with the JAX
init's shapes and scales: a normal draw in float32, times the scale, cast
to the parameter dtype.  It is not bit-equal to ``jax.random``; runs that
must start from the JAX package's weights carry them over with
:func:`repro_torch.convert.lm_params_from_jax`.

``lead`` prepends axes to every parameter an init makes: the stack draws
the parameters of one period position for all ``n_super`` super-blocks at
once, stacked as the JAX package's ``vmap`` stacks them.

On a mesh the embedding is vocab-parallel (``vocab`` over ``model``):
:func:`embed_tokens_shard` looks up a shard's own rows of the table and
writes zeros for the rest (the partials sum over ``model`` to the
lookup, exactly), and :func:`unembed` on a shard's rows gives its slice
of the fp32 logits, soft-capped per shard.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def normal(gen: torch.Generator, shape: Sequence[int], scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """float32 N(0, 1) * scale, cast to ``dtype``, on ``gen``'s device."""
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------- norms ----

def init_norm(d: int, norm: str, device, lead: Tuple[int, ...] = ()):
    """float32 ones (and zeros for a layernorm bias), whatever the
    parameter dtype, as in the JAX package."""
    shape = tuple(lead) + (d,)
    p = {"scale": torch.ones(shape, dtype=torch.float32, device=device)}
    if norm != "rmsnorm":
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def rms_normalize(xf: torch.Tensor, mean_sq: torch.Tensor,
                  scale: torch.Tensor, dtype, eps: float = 1e-6
                  ) -> torch.Tensor:
    """The RMS norm of fp32 ``xf`` given its mean square over the normed
    dimension (of which ``xf`` and ``scale`` may be one block), cast to
    ``dtype``."""
    return (xf * torch.rsqrt(mean_sq + eps) * scale.float()).to(dtype)


def apply_norm(p, x: torch.Tensor, norm: str, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if norm == "rmsnorm":
        return rms_normalize(xf, torch.mean(xf * xf, dim=-1, keepdim=True),
                             p["scale"], x.dtype, eps)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns
    ``x`` itself above 20, up to 2e-9 away)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# --------------------------------------------------------------- dense -----

def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, scale: Optional[float] = None,
               lead: Tuple[int, ...] = ()):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"kernel": normal(gen, tuple(lead) + (d_in, d_out), scale, dtype)}


# ------------------------------------------------------------ embedding ----

def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16):
    return {"table": normal(gen, (vocab, d), 1.0 / math.sqrt(d), dtype)}


def embed_tokens(p, tokens: torch.Tensor, *, scale: bool = False
                 ) -> torch.Tensor:
    x = p["table"][tokens]
    if scale:
        # sqrt(d) rounded to the table's dtype first (bf16: 73.5 for d=5376),
        # as the JAX package multiplies by jnp.asarray(sqrt(d), x.dtype)
        x = x * torch.tensor(math.sqrt(p["table"].shape[1]), dtype=x.dtype,
                             device=x.device)
    return x


def embed_tokens_shard(p, tokens: torch.Tensor, lo: int, *,
                       scale: bool = False) -> torch.Tensor:
    """A vocab shard's partial lookup: ``p["table"]`` holds vocab rows
    [lo, lo + V_l); tokens outside them get zeros."""
    v_l = p["table"].shape[0]
    mine = (tokens >= lo) & (tokens < lo + v_l)
    x = embed_tokens(p, torch.where(mine, tokens - lo, 0), scale=scale)
    return torch.where(mine[..., None], x, torch.zeros(
        (), dtype=x.dtype, device=x.device))


def unembed(p, x: torch.Tensor, *, softcap: float = 0.0) -> torch.Tensor:
    """fp32 logits against the (V, D) table, cast to fp32 as in JAX."""
    logits = torch.matmul(x.float(), p["table"].float().t())
    if softcap > 0.0:
        # a tensor divisor (CUDA divides by a Python scalar through its
        # reciprocal, an ulp off the true quotient)
        logits = torch.tanh(logits / torch.tensor(
            softcap, dtype=torch.float32, device=logits.device)) * softcap
    return logits


# --------------------------------------------------------------- rotary ----

def rotary_exponents(rotary_dim: int, device=None) -> torch.Tensor:
    """``arange(0, rotary_dim, 2) / rotary_dim`` in float32, a true
    division (by a tensor: CUDA divides by a Python scalar through its
    reciprocal, an ulp off at 15 of the 48 exponents of rotary_dim 96)."""
    return torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=device) / torch.tensor(
        float(rotary_dim), dtype=torch.float32, device=device)


def rotary_angles(positions: torch.Tensor, rotary_dim: int, theta: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions.  Shapes (..., rotary_dim/2)."""
    exps = rotary_exponents(rotary_dim, positions.device)
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 rotary_pct: float = 1.0) -> torch.Tensor:
    """RoPE on the leading ``rotary_pct`` of the head dim, INTERLEAVED pairs.

    ``x``: (..., seq, heads, head_dim); cos/sin: (..., seq, rot/2).  The
    pairs are (x[0::2], x[1::2]) and the rotated halves are interleaved
    back, as the JAX package does (not the half-split ``rotate_half``).
    rotary_pct < 1 (ChatGLM) rotates only the first part of each head.
    """
    hd = x.shape[-1]
    rot = int(hd * rotary_pct)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    xf = x_rot.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    c = cos[..., None, :]     # broadcast over the heads axis
    s = sin[..., None, :]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    y = torch.stack([y1, y2], dim=-1).reshape(xf.shape).to(x.dtype)
    return torch.cat([y, x_pass], dim=-1) if x_pass.shape[-1] else y


# ----------------------------------------------------- sinusoidal (abs) ----

def _sinusoid_freqs(d: int, device) -> torch.Tensor:
    return torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                  device=device) * (-math.log(10000.0) / d))


def _interleave(ang: torch.Tensor) -> torch.Tensor:
    """sin at the even columns, cos at the odd ones."""
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).flatten(-2)


def sinusoid_at(pos: int, d: int, device=None) -> torch.Tensor:
    """The sinusoidal embedding (d,) float32 of one position (a host int)."""
    return _interleave(float(pos) * _sinusoid_freqs(d, device))


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings (seq, d), float32."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    return _interleave(pos * _sinusoid_freqs(d, device))
