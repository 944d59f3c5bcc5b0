"""Loop-aware analytic cost model for the roofline report: the JAX
package's ``repro.launch.analytic_cost`` on the port's ``ModelConfig``.

The JAX package needs it because XLA's HloCostAnalysis counts a
``while``-loop body once; the port's dry-run counts every executed op
(``launch.hlo_analysis.CostCounter``), so here the analytic terms are a
second opinion printed beside the trace's.  The formulas are the
reference's, unchanged (tests hold them equal for every arch x shape);
only ``analytic_terms``' default peaks are the H100's.

The model (per GLOBAL step; divide by devices for per-device):

FLOPs
  dense matmul work      6*N*D_tokens (train, +2ND remat refwd = 8ND),
                         2*N*D (prefill/decode);   N = active params
  attention              4*B*S*W*H*hd per layer fwd (W = S full, window
                         local, cache decode), x2 bwd, +fwd for remat
  logits                 2*T*d*V (x3 train)
  mamba scan             ~12*B*S*di*ds per layer fwd (discretise+scan+out)
  mlstm chunk            ~4*B*S*Q*H*hd intra + 4*B*S*hd*hd inter per layer

Bytes (HBM traffic)
  params                 train: read bf16 + grad fp32 w + opt fp32 r/w
                         (16 B/param + 8 adam / 4 adafactor);
                         prefill/decode: 2 B/param per step
  activations            ~14 R/W of (B,S,D) bf16 per layer fwd, x2 train
  KV cache / states      decode: full cache read + one-slot write
  logits                 T*V*4 r/w
"""

from __future__ import annotations

import math
from typing import Dict

from repro_torch.models.config import ModelConfig

# the default peaks of analytic_terms: one H100 SXM at 700 W (NVIDIA's data
# sheet, dense bf16 on the tensor cores; HBM3), as launch.hlo_analysis's
# Hardware holds them
H100_BF16_FLOPS = 989e12
H100_HBM_BW = 3.35e12


def _active_params(cfg: ModelConfig) -> float:
    """Active (per-token) parameter count, MoE counting top_k experts."""
    n = 0.0
    d = cfg.d_model
    hd = cfg.head_dim_
    for spec in cfg.layout():
        if spec.mixer in ("attn", "attn_local"):
            n += d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        elif spec.mixer == "mamba":
            di = cfg.mamba.expand * d
            dr = cfg.mamba.dt_rank or max(1, math.ceil(d / 16))
            n += d * 2 * di + di * (dr + 2 * cfg.mamba.d_state) \
                + dr * di + di * d
        elif spec.mixer in ("mlstm", "slstm"):
            di = int(cfg.xlstm.proj_factor * d)
            n += d * 2 * di + di * d
            hd_x = di // cfg.num_heads
            # mlstm q/k/v are per-head block-diagonal (3 * H * hd^2)
            n += (3 * di * hd_x if spec.mixer == "mlstm"
                  else 4 * di * di + 4 * di * hd_x)
        if spec.cross_attention:
            n += d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        if spec.ff == "dense":
            mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
            n += mats * d * cfg.d_ff
        elif spec.ff == "moe":
            mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
            n += mats * d * cfg.moe.d_ff_expert * cfg.moe.top_k
    for spec in (cfg.encoder_layout() if cfg.is_encdec else []):
        n += d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
        n += mats * d * cfg.d_ff
    return n


def total_params(cfg: ModelConfig) -> float:
    n = _active_params(cfg)
    if cfg.moe is not None:
        # add the inactive experts
        mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
        per_layer_extra = (mats * cfg.d_model * cfg.moe.d_ff_expert
                           * (cfg.moe.num_experts - cfg.moe.top_k))
        n += per_layer_extra * sum(
            1 for s in cfg.layout() if s.ff == "moe")
    n += cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return n


def _attn_flops(cfg: ModelConfig, b: int, s: int, kind: str) -> float:
    total = 0.0
    hd = cfg.head_dim_
    h = cfg.num_heads
    for spec in cfg.layout():
        if spec.mixer == "attn":
            w = s if kind != "decode" else s      # cache length
            per = 4.0 * b * (s if kind != "decode" else 1) * w * h * hd
            if kind != "decode":
                per *= 0.5                         # causal mask halves
        elif spec.mixer == "attn_local":
            win = min(spec.window or cfg.window_size, s)
            per = 4.0 * b * (s if kind != "decode" else 1) * win * h * hd
        elif spec.mixer == "mamba":
            di = cfg.mamba.expand * cfg.d_model
            per = 12.0 * b * (s if kind != "decode" else 1) * di \
                * cfg.mamba.d_state
        elif spec.mixer == "mlstm":
            di = int(cfg.xlstm.proj_factor * cfg.d_model)
            hh, dh = cfg.num_heads, di // cfg.num_heads
            q = cfg.xlstm.chunk_size
            toks = s if kind != "decode" else 1
            per = 4.0 * b * toks * min(q, s) * hh * dh \
                + 4.0 * b * toks * dh * dh * hh
        else:                                      # slstm
            di = int(cfg.xlstm.proj_factor * cfg.d_model)
            per = 8.0 * b * (s if kind != "decode" else 1) * di
        if spec.cross_attention and cfg.is_encdec:
            enc = min(s, cfg.encoder_seq_cap)
            per += 4.0 * b * (s if kind != "decode" else 1) * enc * h * hd
        total += per
    mult = {"train": 4.0, "prefill": 1.0, "decode": 1.0}[kind]
    return total * mult   # train: fwd + 2x bwd + remat refwd


def analytic_flops(cfg: ModelConfig, seq: int, batch: int, kind: str,
                   remat: bool = True) -> float:
    n = _active_params(cfg)
    tokens = batch * (seq if kind != "decode" else 1)
    if kind == "train":
        base = (8.0 if remat else 6.0) * n * tokens
        logits = 6.0 * tokens * cfg.d_model * cfg.vocab_size
    else:
        base = 2.0 * n * tokens
        logits = 2.0 * (batch if kind != "train" else tokens) \
            * cfg.d_model * cfg.vocab_size
    return base + logits + _attn_flops(cfg, batch, seq, kind)


def analytic_bytes(cfg: ModelConfig, seq: int, batch: int, kind: str,
                   optimizer: str = "adamw") -> float:
    p = total_params(cfg)
    d = cfg.d_model
    layers = cfg.num_layers + cfg.encoder_layers
    tokens = batch * (seq if kind != "decode" else 1)
    if kind == "train":
        opt = 16.0 if optimizer == "adamw" else 6.0
        param_traffic = p * (2.0 + 4.0 + opt)     # bf16 read, grad, opt r/w
        act = 14.0 * 2.0 * tokens * d * 2.0 * layers
        logits = tokens * cfg.vocab_size * 8.0
        return param_traffic + act + logits
    if kind == "prefill":
        return p * 2.0 + 14.0 * tokens * d * 2.0 * layers \
            + batch * cfg.vocab_size * 4.0
    # decode: every param read once; KV/states read once
    cache = 0.0
    for spec in cfg.layout():
        if spec.mixer == "attn":
            cache += 2.0 * batch * seq * cfg.num_kv_heads * cfg.head_dim_ * 2
        elif spec.mixer == "attn_local":
            win = min(spec.window or cfg.window_size, seq)
            cache += 2.0 * batch * win * cfg.num_kv_heads * cfg.head_dim_ * 2
        elif spec.mixer == "mamba":
            di = cfg.mamba.expand * cfg.d_model
            cache += batch * di * cfg.mamba.d_state * 4
        elif spec.mixer in ("mlstm",):
            di = int(cfg.xlstm.proj_factor * cfg.d_model)
            hh = cfg.num_heads
            cache += batch * hh * (di // hh) ** 2 * 4
        else:
            di = int(cfg.xlstm.proj_factor * cfg.d_model)
            cache += 4 * batch * di * 4
    return p * 2.0 + cache + batch * cfg.vocab_size * 4.0


def analytic_terms(cfg: ModelConfig, seq: int, batch: int, kind: str,
                   num_devices: int, *, optimizer: str = "adamw",
                   peak_flops: float = H100_BF16_FLOPS,
                   hbm_bw: float = H100_HBM_BW) -> Dict[str, float]:
    fl = analytic_flops(cfg, seq, batch, kind)
    by = analytic_bytes(cfg, seq, batch, kind, optimizer)
    return {
        "analytic_flops_total": fl,
        "analytic_bytes_total": by,
        "analytic_compute_term_s": fl / (num_devices * peak_flops),
        "analytic_memory_term_s": by / (num_devices * hbm_bw),
    }
