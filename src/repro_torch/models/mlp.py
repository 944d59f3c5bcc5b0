"""Feed-forward blocks: SwiGLU / GEGLU (gated), GELU, squared-ReLU.

The counterpart of ``repro.models.mlp``.  ``gelu`` and ``geglu`` use the
tanh approximation, which is what ``jax.nn.gelu`` computes by default.
On a mesh (``blocks._mesh_block``) :func:`apply_mlp` runs on a ``model``
shard's columns of ``w_up``/``w_gate`` and rows of ``w_down`` (the
``mlp`` axis): its output is that shard's partial sum, summed over
``model`` once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

GATED = ("swiglu", "geglu")


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype, lead=()) -> dict:
    p = {"w_up": layers.init_dense(gen, d_model, d_ff, dtype,
                                   lead=lead)["kernel"],
         "w_down": layers.init_dense(gen, d_ff, d_model, dtype,
                                     lead=lead)["kernel"]}
    if activation in GATED:
        p["w_gate"] = layers.init_dense(gen, d_model, d_ff, dtype,
                                        lead=lead)["kernel"]
    return p


def _act(activation: str, x: torch.Tensor) -> torch.Tensor:
    if activation == "swiglu":
        return F.silu(x)
    if activation in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")
    if activation == "squared_relu":            # nemotron-4
        r = F.relu(x)
        return r * r
    raise ValueError(activation)


def apply_mlp(p, x: torch.Tensor, activation: str) -> torch.Tensor:
    dt = x.dtype
    up = torch.matmul(x, p["w_up"].to(dt))
    if activation in GATED:
        gate = torch.matmul(x, p["w_gate"].to(dt))
        h = _act(activation, gate) * up
    else:
        h = _act(activation, up)
    return torch.matmul(h, p["w_down"].to(dt))
