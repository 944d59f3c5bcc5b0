"""xLSTM blocks (Beck et al., arXiv:2405.04517): mLSTM and sLSTM.

The counterpart of ``repro.models.xlstm``.

* mLSTM: matrix-memory LSTM with exponential gating.  Training and
  prefill use the chunkwise-parallel stabilised form: a Python loop over
  chunks of ``cfg.xlstm.chunk_size`` (the JAX package's outer
  ``lax.scan``) carries the stabilised ``(C, n, m)`` state; within a
  chunk the (Q x Q) masked-decay attention computes exact outputs.  The
  last chunk is not padded (the JAX package's zero pad changes no output
  before it, and the carry out of the last chunk is not used).  Decode is
  the exact single-step recurrence.
* sLSTM: scalar-memory LSTM with per-head block-diagonal recurrent
  connections: a recurrence over time, a Python loop over the sequence
  (the JAX package's ``lax.scan``), several launches a step.

Both sit in xLSTM's up-projection block:
    x -> up(2*di) -> [core(x_half) * silu(gate_half)] -> down(d)

The stabiliser ``max(|den|, exp(-m))``, the initial ``m = -1e30``,
sLSTM's initial ``n = 1e-6``, the forget-gate bias 3.0 and the z/i/f/o
column order of ``w_gates``/``b_gates`` are the JAX package's.

On a ``(data, model)`` mesh (``*_shard``) each ``model`` shard owns a
block of the inner channels and runs the heads they fall in
(:func:`share`); the contractions over the channels (the ``w_i``/``w_f``
and ``w_gates`` gate inputs, ``out_norm``'s mean square and ``down``)
are summed over ``model`` before what follows them.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def d_inner(cfg: ModelConfig) -> int:
    return int(cfg.xlstm.proj_factor * cfg.d_model)


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    h = cfg.num_heads
    di = d_inner(cfg)
    assert di % h == 0
    return h, di // h


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``-softplus(-x)``, as the JAX package writes it."""
    return -layers.softplus(-x)


def _blockdiag(gen, lead, h, hd, dtype):
    """Per-head block-diagonal (H, hd, hd) weights, N(0, 1) / sqrt(hd)."""
    return layers.normal(gen, lead + (h, hd, hd), 1.0 / math.sqrt(hd), dtype)


def _up_split(p, x: torch.Tensor, di: int):
    up = torch.matmul(x, p["up"].to(x.dtype))
    return up[..., :di], up[..., di:]


def _down(p, hcat: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """out_norm (rmsnorm), the silu gate and the down projection."""
    hcat = layers.apply_norm(p["out_norm"], hcat, "rmsnorm")
    return torch.matmul(hcat * F.silu(gate), p["down"].to(hcat.dtype))


# ------------------------------------------------------------- mLSTM -------

def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype,
               lead=()) -> dict:
    d, di = cfg.d_model, d_inner(cfg)
    h, hd = _heads(cfg)
    lead = tuple(lead)
    dev = gen.device

    def dense(d_in, d_out, dt):
        return layers.init_dense(gen, d_in, d_out, dt, lead=lead)["kernel"]

    return {
        "up": dense(d, 2 * di, dtype),
        "wq": _blockdiag(gen, lead, h, hd, dtype),
        "wk": _blockdiag(gen, lead, h, hd, dtype),
        "wv": _blockdiag(gen, lead, h, hd, dtype),
        "w_i": dense(di, h, torch.float32),
        "b_i": torch.zeros(lead + (h,), dtype=torch.float32, device=dev),
        "w_f": dense(di, h, torch.float32),
        # open forget gates at init
        "b_f": torch.full(lead + (h,), 3.0, dtype=torch.float32, device=dev),
        "out_norm": layers.init_norm(di, "rmsnorm", dev, lead),
        "down": dense(di, d, dtype),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd, hd) fp32, stabilised by exp(-m)
    n: torch.Tensor   # (B, H, hd)
    m: torch.Tensor   # (B, H)

    @staticmethod
    def zeros(b: int, cfg: ModelConfig, device, lead=(), heads=None
              ) -> "MLSTMState":
        """The initial state of ``heads`` heads (all of them: None)."""
        h, hd = _heads(cfg)
        h = h if heads is None else heads
        lead = tuple(lead)

        def z(*shape):
            return torch.zeros(lead + shape, dtype=torch.float32,
                               device=device)
        return MLSTMState(c=z(b, h, hd, hd), n=z(b, h, hd),
                          m=torch.full(lead + (b, h), -1e30,
                                       dtype=torch.float32, device=device))


def _qkv(p, xin: torch.Tensor):
    """xin: (B, S, H_p * hd) -> q, k, v (B, S, H_p, hd) for the heads of
    ``p["wq"]`` (H_p, hd, hd): per-head block-diagonal (official xLSTM),
    q divided by sqrt(hd)."""
    b, s, _ = xin.shape
    h, hd = p["wq"].shape[0], p["wq"].shape[-1]
    dt = xin.dtype
    xh = xin.reshape(b, s, h, hd)
    q, k, v = (torch.einsum("bshd,hde->bshe", xh, p[w].to(dt))
               for w in ("wq", "wk", "wv"))
    # divided by a tensor, as the JAX package divides by sqrt(hd) at run
    # time (CUDA divides by a Python scalar through its reciprocal)
    q = q / torch.tensor(math.sqrt(hd), dtype=dt, device=q.device)
    return q, k, v


def _gates(p, i_raw: torch.Tensor, f_raw: torch.Tensor):
    """The input and forget gates' pre-activations (B, S, H) (their
    ``w_i``/``w_f`` contractions) -> log_i, log_f, fp32."""
    return i_raw + p["b_i"], _log_sigmoid(f_raw + p["b_f"])


def _qkv_gates(p, cfg: ModelConfig, xin: torch.Tensor):
    """xin: (B, S, di) -> q, k, v (B, S, H, hd); log_i, log_f (B, S, H)
    fp32."""
    q, k, v = _qkv(p, xin)
    xf = xin.float()
    log_i, log_f = _gates(p, torch.matmul(xf, p["w_i"]),
                          torch.matmul(xf, p["w_f"]))
    return q, k, v, log_i, log_f


def _mlstm_chunk(state: MLSTMState, q, k, v, log_i, log_f):
    """Exact stabilised chunk step.

    q, k, v: (B, Q, H, hd); log_i/log_f: (B, Q, H).
    Returns (state', h (B, Q, H, hd) fp32).
    """
    qlen = q.shape[1]
    c_st, n_st, m_st = state
    bq = torch.cumsum(log_f, dim=1)                      # (B,Q,H) inclusive
    # local stabiliser: m_loc[q] = b_q + cummax_{j<=q} (log_i_j - b_j)
    cmax = torch.cummax(log_i - bq, dim=1).values
    m_loc = bq + cmax
    m_new = torch.maximum(m_loc, m_st[:, None, :] + bq)  # (B,Q,H)

    # intra-chunk decay: logD[q, j] = b_q - b_j + log_i_j  (j <= q)
    logd = (bq[:, :, None, :] - bq[:, None, :, :]
            + log_i[:, None, :, :])                      # (B,Q,J,H)
    ar = torch.arange(qlen, device=q.device)
    mask = (ar[:, None] >= ar[None, :])[None, :, :, None]
    logd = torch.where(mask, logd, -math.inf)
    w = torch.exp(logd - m_new[:, :, None, :])           # (B,Q,J,H)

    qf, kf, vf = q.float(), k.float(), v.float()
    qk = torch.einsum("bqhd,bjhd->bqjh", qf, kf)         # (B,Q,J,H)
    s_mat = qk * w
    num_intra = torch.einsum("bqjh,bjhd->bqhd", s_mat, vf)
    den_intra = torch.sum(s_mat, dim=2)                  # (B,Q,H)

    scale_inter = torch.exp(m_st[:, None, :] + bq - m_new)   # (B,Q,H)
    num_inter = torch.einsum("bqhd,bhde->bqhe", qf, c_st)
    num_inter = num_inter * scale_inter[..., None]
    den_inter = torch.einsum("bqhd,bhd->bqh", qf, n_st) * scale_inter

    num = num_intra + num_inter
    den = den_intra + den_inter
    denom = torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    h_out = num / denom                                  # (B,Q,H,hd)

    # carry update: decay everything to the chunk's end, stabilise by m'
    b_tot = bq[:, -1, :]                                 # (B,H)
    m_next = torch.maximum(m_st + b_tot, b_tot + cmax[:, -1, :])
    kv_w = torch.exp(b_tot[:, None, :] - bq + log_i
                     - m_next[:, None, :])               # (B,Q,H)
    decay = torch.exp(m_st + b_tot - m_next)
    c_new = (c_st * decay[..., None, None]
             + torch.einsum("bqh,bqhd,bqhe->bhde", kv_w, kf, vf))
    n_new = (n_st * decay[..., None]
             + torch.einsum("bqh,bqhd->bhd", kv_w, kf))
    return MLSTMState(c_new, n_new, m_next), h_out


def _mlstm_cell(cfg: ModelConfig, q, k, v, log_i, log_f) -> torch.Tensor:
    """The chunkwise mLSTM over the heads of q: (B, S, H_p * hd) fp32."""
    b, s, h, hd = q.shape
    qc = max(1, min(cfg.xlstm.chunk_size, s))
    st = MLSTMState.zeros(b, cfg, q.device, heads=h)
    hs = []
    for c0 in range(0, s, qc):
        st, hh = _mlstm_chunk(st, *(t[:, c0:c0 + qc]
                                    for t in (q, k, v, log_i, log_f)))
        hs.append(hh)
    return torch.cat(hs, dim=1).reshape(b, s, h * hd)


def mlstm_forward(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    xin, z = _up_split(p, x, d_inner(cfg))
    q, k, v, log_i, log_f = _qkv_gates(p, cfg, xin)
    return _down(p, _mlstm_cell(cfg, q, k, v, log_i, log_f).to(x.dtype), z)


def _mlstm_step(state: MLSTMState, q, k, v, log_i, log_f):
    """One token's exact recurrence: q/k/v (B, 1, H_p, hd), the gates
    (B, 1, H_p) -> (h (B, H_p, hd) fp32, the new state)."""
    qf, kf, vf = (t[:, 0].float() for t in (q, k, v))     # (B,H,hd)
    log_i, log_f = log_i[:, 0], log_f[:, 0]              # (B,H)
    c_st, n_st, m_st = state
    m_new = torch.maximum(log_f + m_st, log_i)
    fs = torch.exp(log_f + m_st - m_new)
    is_ = torch.exp(log_i - m_new)
    c_new = fs[..., None, None] * c_st + is_[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n_new = fs[..., None] * n_st + is_[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, c_new)
    den = torch.abs(torch.einsum("bhd,bhd->bh", qf, n_new))
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return h, MLSTMState(c_new, n_new, m_new)


def mlstm_decode(p, cfg: ModelConfig, x: torch.Tensor, state: MLSTMState
                 ) -> Tuple[torch.Tensor, MLSTMState]:
    """x: (B, 1, D) -> ((B, 1, D), the new state: fresh tensors)."""
    b = x.shape[0]
    di = d_inner(cfg)
    xin, z = _up_split(p, x, di)
    h, new = _mlstm_step(state, *_qkv_gates(p, cfg, xin))
    return _down(p, h.reshape(b, 1, di).to(x.dtype), z), new


# ------------------------------------------------------------- sLSTM -------

def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype,
               lead=()) -> dict:
    d, di = cfg.d_model, d_inner(cfg)
    h, hd = _heads(cfg)
    lead = tuple(lead)
    dev = gen.device

    def dense(d_in, d_out):
        return layers.init_dense(gen, d_in, d_out, dtype, lead=lead)["kernel"]

    p = {"up": dense(d, 2 * di), "w_gates": dense(di, 4 * di)}
    for g in ("r_z", "r_i", "r_f", "r_o"):     # per-head recurrent, fp32
        p[g] = _blockdiag(gen, lead, h, hd, torch.float32)
    zeros = torch.zeros(lead + (2 * di,), dtype=torch.float32, device=dev)
    p["b_gates"] = torch.cat([
        zeros, torch.full(lead + (di,), 3.0, dtype=torch.float32,
                          device=dev), zeros[..., :di]], dim=-1)
    p["out_norm"] = layers.init_norm(di, "rmsnorm", dev, lead)
    p["down"] = dense(di, d)
    return p


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd) fp32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor

    @staticmethod
    def zeros(b: int, cfg: ModelConfig, device, lead=(), heads=None
              ) -> "SLSTMState":
        """The initial state of ``heads`` heads (all of them: None)."""
        hh, hd = _heads(cfg)
        shape = tuple(lead) + (b, hh if heads is None else heads, hd)

        def full(v):
            return torch.full(shape, v, dtype=torch.float32, device=device)
        return SLSTMState(c=full(0.0), n=full(1e-6), h=full(0.0),
                          m=full(-1e30))


def _slstm_step(p, st: SLSTMState, wx: torch.Tensor
                ) -> Tuple[SLSTMState, torch.Tensor]:
    """wx: (B, 4 * H_p * hd) precomputed input contribution (fp32) of the
    heads of ``p["r_z"]`` (H_p, hd, hd)."""
    h, hd = p["r_z"].shape[0], p["r_z"].shape[-1]
    b = wx.shape[0]
    di = h * hd

    def rec(r):   # (B,H,hd) x (H,hd,hd) -> (B,H,hd)
        return torch.einsum("bhd,hde->bhe", st.h, r)

    wz, wi, wf, wo = (wx[:, i * di:(i + 1) * di].reshape(b, h, hd)
                      for i in range(4))
    z = torch.tanh(wz + rec(p["r_z"]))
    log_i = wi + rec(p["r_i"])
    log_f = _log_sigmoid(wf + rec(p["r_f"]))
    o = torch.sigmoid(wo + rec(p["r_o"]))
    m_new = torch.maximum(log_f + st.m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + st.m - m_new)
    c = f_s * st.c + i_s * z
    n = f_s * st.n + i_s
    h_out = o * c / torch.clamp(n, min=1e-6)
    return SLSTMState(c, n, h_out, m_new), h_out


def _gate_inputs(p, xin: torch.Tensor) -> torch.Tensor:
    return (torch.matmul(xin, p["w_gates"].to(xin.dtype)).float()
            + p["b_gates"])


def _slstm_loop(p, st: SLSTMState, wx: torch.Tensor) -> torch.Tensor:
    """The recurrence over time from ``st``: wx (B, S, 4 * H_p * hd) ->
    h (B, S, H_p * hd) fp32."""
    b, s, _ = wx.shape
    hs = []
    for t in range(s):
        st, h = _slstm_step(p, st, wx[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1).reshape(b, s, -1)


def slstm_forward(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    di = d_inner(cfg)
    xin, zgate = _up_split(p, x, di)
    st = SLSTMState.zeros(x.shape[0], cfg, x.device)
    hcat = _slstm_loop(p, st, _gate_inputs(p, xin))
    return _down(p, hcat.to(x.dtype), zgate)


def slstm_decode(p, cfg: ModelConfig, x: torch.Tensor, state: SLSTMState
                 ) -> Tuple[torch.Tensor, SLSTMState]:
    b = x.shape[0]
    di = d_inner(cfg)
    xin, zgate = _up_split(p, x, di)
    st, h = _slstm_step(p, state, _gate_inputs(p, xin)[:, 0])
    return _down(p, h.reshape(b, 1, di).to(x.dtype), zgate), st


# ------------------------------------------------------------ on a mesh ----

class Share(NamedTuple):
    """A ``model`` shard's share of an xLSTM layer: the heads it runs
    (those its own inner channels fall in, whole), its own channels
    within those heads' channels, and the same channels of the whole
    inner dimension."""
    heads: slice
    own: slice
    channels: slice


def share(cfg: ModelConfig, lo: int, hi: int) -> Share:
    """The share of the shard whose own inner channels are [lo, hi)."""
    hd = _heads(cfg)[1]
    h0, h1 = lo // hd, -(-hi // hd)
    return Share(slice(h0, h1), slice(lo - h0 * hd, hi - h0 * hd),
                 slice(lo, hi))


def up_columns(cfg: ModelConfig, sh: Share):
    """The columns of ``up`` a shard reads: its heads' channels of the
    cell's input half, then its own channels of the gate half."""
    di, hd = d_inner(cfg), _heads(cfg)[1]
    return [(sh.heads.start * hd, sh.heads.stop * hd),
            (di + sh.channels.start, di + sh.channels.stop)]


def _up_shard(p, x: torch.Tensor, sh: Share):
    """``x @ up`` on a shard's columns: (the cell's input over its heads'
    channels, its own channels of it, the gate half on its own)."""
    up = torch.matmul(x, p["up"].to(x.dtype))
    n = up.shape[-1] - (sh.own.stop - sh.own.start)
    return up[..., :n], up[..., :n][..., sh.own], up[..., n:]


def _down_shard(p, h: torch.Tensor, z: torch.Tensor, sumsq: torch.Tensor,
                sh: Share, di: int) -> torch.Tensor:
    """``out_norm`` over the whole inner dimension from the squares summed
    over ``model``, the silu gate and a shard's partial of ``down`` on
    its own channels ``h``."""
    y = layers.rms_normalize(h.float(), sumsq / di,
                             p["out_norm"]["scale"][sh.channels], h.dtype)
    return torch.matmul(y * F.silu(z), p["down"].to(h.dtype))


def _sumsq(h: torch.Tensor) -> torch.Tensor:
    hf = h.float()
    return torch.sum(hf * hf, dim=-1, keepdim=True)


def _run_shards(ps, cfg: ModelConfig, xs, shares, psum, pre, cell):
    """The skeleton of every ``*_shard`` function.  ``pre(p, x, sh)`` ->
    (the gate half z, the partial of the contraction over the shard's
    channels, what the cell reads); the partials summed by ``psum``
    (every device's partials -> the sums over ``model``; the identity
    where the inner dimension is not cut); ``cell(k, p, read, summed,
    sh)`` -> (h over the shard's heads, the new state of its heads or
    None); ``out_norm``'s squares of the shard's own channels of h summed
    by ``psum``; ``out_norm``, the gate and ``down``.  Returns (each
    device's ``down`` partial, each device's new state)."""
    di = d_inner(cfg)
    parts = [pre(p, x, sh) for p, x, sh in zip(ps, xs, shares)]
    summed = psum([g for _, g, _ in parts])
    hs, new = [], []
    for k, (p, (z, _, read), g, sh) in enumerate(zip(ps, parts, summed,
                                                     shares)):
        h, st = cell(k, p, read, g, sh)
        hs.append(h.to(z.dtype)[..., sh.own])
        new.append(st)
    sumsq = psum([_sumsq(h) for h in hs])
    return [_down_shard(p, h, z, ss, sh, di) for p, h, (z, _, _), ss, sh
            in zip(ps, hs, parts, sumsq, shares)], new


def _heads_of(p, sh: Share) -> dict:
    """An sLSTM's ``p`` with its recurrent weights (whole on every
    device) cut to the shard's heads."""
    return dict(p, **{r: p[r][sh.heads] for r in ("r_z", "r_i", "r_f",
                                                   "r_o")})


def _state_heads(st, sh: Share):
    """A shard's heads of a whole (replicated) recurrent state."""
    return type(st)(*(t[:, sh.heads] for t in st))


def _mlstm_pre(p, x, sh: Share):
    xin, own, z = _up_shard(p, x, sh)
    xf = own.float()
    return z, torch.cat([torch.matmul(xf, p["w_i"]),
                         torch.matmul(xf, p["w_f"])], dim=-1), xin


def _split_gates(p, g: torch.Tensor, sh: Share):
    h = g.shape[-1] // 2
    log_i, log_f = _gates(p, g[..., :h], g[..., h:])
    return log_i[..., sh.heads], log_f[..., sh.heads]


def mlstm_forward_shard(ps, cfg: ModelConfig, xs, shares, psum
                        ) -> List[torch.Tensor]:
    """Every ``model`` shard's mLSTM forward: device ``k`` runs the heads
    of ``shares[k]`` with ``ps[k]`` (``up`` read at :func:`up_columns`,
    ``wq``/``wk``/``wv`` whole for its heads, its rows of ``w_i``,
    ``w_f`` and ``down``) on its input ``xs[k]``, the ``w_i``/``w_f``
    contractions summed before the gates' nonlinearity and ``out_norm``'s
    squares before the divide (:func:`_run_shards`).  Returns each
    device's ``down`` partial."""
    def cell(k, p, xin, g, sh):
        return _mlstm_cell(cfg, *_qkv(p, xin), *_split_gates(p, g, sh)), None
    return _run_shards(ps, cfg, xs, shares, psum, _mlstm_pre, cell)[0]


def mlstm_decode_shard(ps, cfg: ModelConfig, xs, states, shares, psum
                       ) -> Tuple[List[torch.Tensor], List[MLSTMState]]:
    """One decode step of every shard from its (whole, replicated) state
    ``states[k]``: :func:`mlstm_forward_shard`'s split.  Returns (each
    device's ``down`` partial, the new state of its heads)."""
    def cell(k, p, xin, g, sh):
        h, st = _mlstm_step(_state_heads(states[k], sh), *_qkv(p, xin),
                            *_split_gates(p, g, sh))
        return h.reshape(h.shape[0], 1, -1), st
    return _run_shards(ps, cfg, xs, shares, psum, _mlstm_pre, cell)


def _slstm_pre(p, x, sh: Share):
    _, own, z = _up_shard(p, x, sh)
    return z, torch.matmul(own, p["w_gates"].to(own.dtype)).float(), None


def _gate_columns(p, wx: torch.Tensor, cfg: ModelConfig, sh: Share):
    """The summed gate inputs plus ``b_gates``, cut to the shard's heads'
    columns of each of the z, i, f, o gates."""
    di, hd = d_inner(cfg), _heads(cfg)[1]
    wx = wx + p["b_gates"]
    lo, hi = sh.heads.start * hd, sh.heads.stop * hd
    return torch.cat([wx[..., i * di + lo:i * di + hi] for i in range(4)],
                     dim=-1)


def slstm_forward_shard(ps, cfg: ModelConfig, xs, shares, psum
                        ) -> List[torch.Tensor]:
    """Every ``model`` shard's sLSTM forward on its heads: ``w_gates``'s
    contraction over the inner channels summed before the recurrence,
    then the loop over time on the shard's heads only, then ``out_norm``
    and ``down`` as :func:`mlstm_forward_shard`."""
    def cell(k, p, _, wx, sh):
        st = SLSTMState.zeros(wx.shape[0], cfg, wx.device,
                              heads=sh.heads.stop - sh.heads.start)
        return _slstm_loop(_heads_of(p, sh), st,
                           _gate_columns(p, wx, cfg, sh)), None
    return _run_shards(ps, cfg, xs, shares, psum, _slstm_pre, cell)[0]


def slstm_decode_shard(ps, cfg: ModelConfig, xs, states, shares, psum
                       ) -> Tuple[List[torch.Tensor], List[SLSTMState]]:
    """One decode step of every shard on its heads of its (whole,
    replicated) state.  Returns (each device's ``down`` partial, the new
    state of its heads)."""
    def cell(k, p, _, wx, sh):
        st, h = _slstm_step(_heads_of(p, sh), _state_heads(states[k], sh),
                            _gate_columns(p, wx, cfg, sh)[:, 0])
        return h.reshape(h.shape[0], 1, -1), st
    return _run_shards(ps, cfg, xs, shares, psum, _slstm_pre, cell)
