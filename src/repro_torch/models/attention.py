"""Grouped-query self-attention: prefill forward and KV-cache decode step.

The counterpart of ``repro.models.attention`` for the dense family:

  * GQA (num_kv_heads < num_heads), query head h reading kv head
    h // (H/Hkv),
  * causal full attention, sliding-window ("local") causal attention with
    a static window, bidirectional attention,
  * RoPE (full or partial "2d"), optional QK-norm,
  * decode: a single-token query against a static KV cache, ring-buffered
    for local layers,
  * cross-attention (enc-dec): decoder queries against the encoder
    output, no mask and no rotary,
  * head parallelism on a mesh (``self_attention_shard``,
    ``decode_self_attention_shard``): a ``model`` shard projects its own
    heads from its columns of ``wq``/``wk``/``wv`` (the weights are cut,
    not q, so the flash kernel reads contiguous (B, S, H/M, hd) inputs),
    attends, and projects out through its rows of ``wo``: a partial
    (B, S, D) the caller sums over ``model``.  Where the kv heads do not
    divide by the axis they are replicated, and a shard reads exactly the
    kv heads its q heads map to.  ``cross_attention_shard`` splits the
    decoder-to-encoder attention the same way.

Shapes: x (B, S, D); q (B, S, H, hd); kv (B, S, Hkv, hd).  Matmuls run in
the compute dtype, the softmax in fp32.  At ``s >= FLASH_MIN_SEQ`` the
causal and local modes route by what the call needs:

  * no gradient to carry (prefill, serving, any call whose q/k/v do not
    require grad): the flash-attention wrapper, the Hopper kernel for
    CUDA tensors and its plain version for CPU tensors (where the JAX
    package routes to its Pallas kernel on a TPU);
  * grad enabled and q, k or v requiring it (training): ``_sdpa_chunked``,
    the JAX package's chunked online-softmax route, its only
    differentiable one at that length (its Pallas kernel has no
    backward, and neither has the port's: the wrapper raises on inputs
    that require grad).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

NEG_INF = -2.3819763e38   # lowest bf16-representable; standard flash value

# Sequences at least this long attend through the flash kernel, or, under
# autograd, through the chunked route in KV chunks of FLASH_CHUNK.
FLASH_CHUNK = 2048
FLASH_MIN_SEQ = 8192


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   lead=()) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    lead = tuple(lead)

    def dense(d_in, d_out, shape, scale=None):
        w = layers.init_dense(gen, d_in, d_out, dtype, scale=scale,
                              lead=lead)["kernel"]
        return w.reshape(lead + shape)

    p = {
        "wq": dense(d, h * hd, (d, h, hd)),
        "wk": dense(d, hkv * hd, (d, hkv, hd)),
        "wv": dense(d, hkv * hd, (d, hkv, hd)),
        "wo": dense(h * hd, d, (h, hd, d), scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qk_norm:
        dev = gen.device
        p["q_norm"] = layers.init_norm(hd, "rmsnorm", dev, lead)
        p["k_norm"] = layers.init_norm(hd, "rmsnorm", dev, lead)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, nh, hd = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, nh * hd)).unflatten(
        -1, (nh, hd))


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        q = layers.apply_norm(p["q_norm"], q, "rmsnorm")
        k = layers.apply_norm(p["k_norm"], k, "rmsnorm")
    if cfg.rope != "none":
        rot = int(cfg.head_dim_ * cfg.rotary_pct)
        rot -= rot % 2
        cos, sin = layers.rotary_angles(positions, rot, cfg.rope_theta)
        q = layers.apply_rotary(q, cos, sin, cfg.rotary_pct)
        k = layers.apply_rotary(k, cos, sin, cfg.rotary_pct)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped scaled-dot-product attention, the JAX package's order:
    scores in the compute dtype, divided by sqrt(hd) in that dtype, then
    cast to fp32 for the masked softmax.

    q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd); mask broadcastable to
    (B, Sq, Skv) (True = attend).
    """
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    scores = torch.einsum("bqhgk,bshk->bhgqs", qg, k)
    scores = scores / torch.tensor(math.sqrt(hd), dtype=scores.dtype,
                                   device=scores.device)
    scores = scores.float()
    if mask is not None:
        m = mask[:, None, None, :, :]
        scores = torch.where(m, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", w, v)
    return out.reshape(b, sq, h, hd)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mode: str, window: int) -> torch.Tensor:
    """Flash-style attention in plain ops, differentiable: a loop over KV
    chunks of ``FLASH_CHUNK`` with a running fp32 max and sum, the tail
    chunk padded (the JAX package's ``_sdpa_chunked``, operation for
    operation).

    q: (B, S, H, hd); k/v: (B, S, Hkv, hd).  Causal ('full') or sliding
    window ('local') masking, self-attention alignment (sq == skv).
    """
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    c = FLASH_CHUNK
    n_chunks = (s + c - 1) // c
    pad = n_chunks * c - s
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    # divided in q's dtype, as the JAX package does, then widened
    qg = (q.reshape(b, s, hkv, g, hd) / torch.tensor(
        math.sqrt(hd), dtype=q.dtype, device=dev)).float()
    qi = torch.arange(s, device=dev)[:, None]
    m_run = torch.full((b, hkv, g, s), NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=dev)
    o_run = torch.zeros((b, hkv, g, s, hd), dtype=torch.float32, device=dev)
    for j in range(n_chunks):
        kj = kp[:, j * c:(j + 1) * c].float()
        vj = vp[:, j * c:(j + 1) * c].float()
        scores = torch.einsum("bqhgk,bjhk->bhgqj", qg, kj)
        kid = j * c + torch.arange(c, device=dev)[None, :]
        valid = kid < s
        if mode == "local":
            m = (kid <= qi) & (kid > qi - window) & valid
        else:
            m = (kid <= qi) & valid
        scores = torch.where(m[None, None, None], scores, NEG_INF)
        m_new = torch.maximum(m_run, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        o_run = (o_run * corr[..., None]
                 + torch.einsum("bhgqj,bjhk->bhgqk", p, vj))
        m_run = m_new
    out = o_run / torch.clamp(l_run[..., None], min=1e-30)
    out = out.movedim(-2, 1).reshape(b, s, h, hd)
    return out.to(q.dtype)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on ``tensors``: grad enabled and
    one of them requiring grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def causal_mask(sq: int, skv: int, offset: int = 0, device=None
                ) -> torch.Tensor:
    """(sq, skv) boolean mask; query i attends kv j iff j <= i + offset."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    return kj <= qi + offset


def local_mask(sq: int, skv: int, window: int, offset: int = 0,
               device=None) -> torch.Tensor:
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    return (kj <= qi + offset) & (kj > qi + offset - window)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matmul."""
    h, hd, d = wo.shape
    return torch.matmul(out.flatten(-2), wo.to(out.dtype).reshape(h * hd, d))


def self_attention(p, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
                   positions: Optional[torch.Tensor] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """Training/prefill self-attention.  mode: full|local|bidir."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    win = window or cfg.window_size
    if (mode in ("full", "local") and s >= FLASH_MIN_SEQ
            and needs_grad(q, k, v)):
        out = _sdpa_chunked(q, k, v, mode=mode, window=win)
    elif mode in ("full", "local") and s >= FLASH_MIN_SEQ:
        out = flash_ops.flash_attention(
            q, k, v, causal=True, window=win if mode == "local" else 0)
    elif mode == "full":
        out = _sdpa(q, k, v, causal_mask(s, s, device=x.device)[None])
    elif mode == "local":
        out = _sdpa(q, k, v, local_mask(s, s, win, device=x.device)[None])
    elif mode == "bidir":
        out = _sdpa(q, k, v, None)
    else:
        raise ValueError(mode)
    return _out_proj(out, p["wo"])


# ------------------------------------------------------------- decode ------

class KVCache(NamedTuple):
    """Static-shape KV cache for one attention layer (or a stacked group).

    k/v: (..., B, C, Hkv, hd) where C = the full sequence budget
    (full/global layers) or the window (local layers: a ring buffer
    indexed pos % C).  Decode writes the new token's k/v IN PLACE: the
    cache is updated, not copied, each step.
    """
    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def zeros(b: int, c: int, hkv: int, hd: int, dtype, device,
              lead=()) -> "KVCache":
        shape = tuple(lead) + (b, c, hkv, hd)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))


def decode_self_attention(p, cfg: ModelConfig, x: torch.Tensor,
                          cache: KVCache, pos: int, *, mode: str,
                          kv_read: Optional[List[int]] = None
                          ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode.  x: (B, 1, D); pos: the current position (a host
    int).  Returns (output (B, 1, D), the cache, updated in place).
    ``kv_read``: the cache's kv heads the queries read (a head-parallel
    shard of a replicated cache), all of them by default."""
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    c = cache.k.shape[1]
    slot = pos % c if mode == "local" else min(pos, c - 1)
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    idx = torch.arange(c, device=x.device)
    if mode == "local":
        # Ring buffer: slot j holds the token written at time
        # t_j = pos - ((pos - j) mod c); it is valid iff t_j >= 0 (the
        # window constraint holds since the buffer length is the window).
        tj = pos - torch.remainder(pos - idx, c)
        valid = (tj >= 0)[None, :]
    else:
        valid = (idx <= pos)[None, :]
    mask = valid[:, None, :]                      # (1, sq=1, C)
    k, v = cache.k, cache.v
    if kv_read is not None:
        idx = torch.tensor(kv_read, device=x.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    out = _sdpa(q, k.to(q.dtype), v.to(q.dtype), mask)
    return _out_proj(out, p["wo"]), cache


# ---------------------------------------------------- head parallelism -----

def _kv_read(lo: int, h_l: int, group: int) -> List[int]:
    """The kv heads q heads [lo, lo + h_l) read (q head h reads h //
    group): each once where they serve equal runs of the local q heads
    (a local GQA group), else one per q head (local MHA)."""
    idx = [h // group for h in range(lo, lo + h_l)]
    uniq = sorted(set(idx))
    per = h_l // len(uniq)
    if h_l % len(uniq) == 0 and idx == [uniq[i // per] for i in range(h_l)]:
        return uniq
    return idx


def _shard_heads(p, cfg: ModelConfig, j: int):
    """Shard ``j``'s view of its attention weights ``p`` (``wq`` cut to
    its heads, ``wk``/``wv`` to its kv heads or whole): (the kv heads it
    reads from the whole kv set, or None where they are cut with the
    heads; whether its output is a partial sum).  The head dim and every
    other setting of ``cfg`` hold per shard as they are."""
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    h_l, hkv_l = p["wq"].shape[-2], p["wk"].shape[-2]
    if h_l == h:
        return None, False
    if hkv_l < hkv:
        return None, True
    return _kv_read(j * h_l, h_l, h // hkv), True


def _shard_view(p, cfg: ModelConfig, j: int) -> Tuple[dict, bool]:
    """Shard ``j``'s weights with ``wk``/``wv`` cut to the kv heads its q
    heads read, and whether its output is a partial sum."""
    kv_read, partial = _shard_heads(p, cfg, j)
    if kv_read is not None:
        idx = torch.tensor(kv_read, device=p["wk"].device)
        p = dict(p, wk=p["wk"].index_select(-2, idx),
                 wv=p["wv"].index_select(-2, idx))
    return p, partial


def self_attention_shard(p, cfg: ModelConfig, x: torch.Tensor, j: int, *,
                         mode: str, window: Optional[int] = None
                         ) -> Tuple[torch.Tensor, bool]:
    """Model shard ``j`` of a head-parallel ``self_attention``: (its
    output, whether that is a partial sum over ``model``)."""
    p, partial = _shard_view(p, cfg, j)
    return self_attention(p, cfg, x, mode=mode, window=window), partial


def decode_self_attention_shard(p, cfg: ModelConfig, x: torch.Tensor,
                                cache: KVCache, pos: int, j: int, *,
                                mode: str
                                ) -> Tuple[torch.Tensor, KVCache, bool]:
    """Model shard ``j`` of a head-parallel decode step on its block of
    the cache (its kv heads, or all of them where they are replicated:
    then it writes every kv head, as each device of a real mesh does, and
    reads those of its q heads).  Returns (output, cache, partial)."""
    kv_read, partial = _shard_heads(p, cfg, j)
    y, cache = decode_self_attention(p, cfg, x, cache, pos, mode=mode,
                                     kv_read=kv_read)
    return y, cache, partial


# ------------------------------------------------------- cross-attention ---

def init_cross_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                         lead=()) -> dict:
    return init_attention(gen, cfg, dtype, lead)


def cross_attention(p, cfg: ModelConfig, x: torch.Tensor, enc: torch.Tensor
                    ) -> torch.Tensor:
    """Decoder -> encoder attention (no rotary, no mask).  x: (B, Sq, D);
    enc: (B, Senc, D).  Decode recomputes the encoder's K/V every step,
    as the JAX package does."""
    enc = enc.to(x.dtype)
    out = _sdpa(_proj(x, p["wq"]), _proj(enc, p["wk"]), _proj(enc, p["wv"]),
                None)
    return _out_proj(out, p["wo"])


def cross_attention_shard(p, cfg: ModelConfig, x: torch.Tensor,
                          enc: torch.Tensor, j: int
                          ) -> Tuple[torch.Tensor, bool]:
    """Model shard ``j`` of a head-parallel ``cross_attention`` (the
    weights under self-attention's head specs): (its output, whether that
    is a partial sum over ``model``)."""
    p, partial = _shard_view(p, cfg, j)
    return cross_attention(p, cfg, x, enc), partial
