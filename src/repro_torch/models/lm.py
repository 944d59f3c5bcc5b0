"""The language model: embeddings -> decoder stack -> logits, the prefill
and the single-token serve step.

The counterpart of ``repro.models.lm`` for the dense family (decoder-only,
``{"tokens": (B, S)}`` input).  Parameters are the JAX package's tree:

  {"embed": {"table"}, "stack": {"super": ..., "rem": ...},
   "final_norm": {"scale"}, ["lm_head": {"table"}]}

so :func:`repro_torch.convert.lm_params_from_jax` carries JAX weights
across unchanged.  ``prefill`` is the JAX package's ``prefill_32k``
dry-run function (``launch/dryrun.py``): the forward pass, keeping the
last position's logits.  The training step waits for ROADMAP A15.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.config import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[cfg.param_dtype]


def plan_for(cfg: ModelConfig) -> blocks.StackPlan:
    return blocks.StackPlan.from_layout(cfg.layout())


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported yet: the port runs "
            f"the dense family; see ROADMAP.md A15")


# ----------------------------------------------------------------- init ----

def init_model(cfg: ModelConfig, generator: torch.Generator,
               device: DeviceLike = None) -> Dict:
    """Random parameters with the JAX init's shapes, dtypes and scales,
    drawn from ``generator`` (which must live on ``device``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: make the generator on the device")
    dt = _dtype(cfg)
    params: Dict[str, Any] = {
        "embed": layers.init_embedding(generator, cfg.vocab_size,
                                       cfg.d_model, dt),
        "stack": blocks.init_stack(generator, cfg, plan_for(cfg), dt),
        "final_norm": layers.init_norm(cfg.d_model, cfg.norm, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_embedding(generator, cfg.vocab_size,
                                                  cfg.d_model, dt)
    return params


# -------------------------------------------------------------- forward ----

def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return layers.embed_tokens(params["embed"], tokens,
                               scale=cfg.embed_scale).to(_dtype(cfg))


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    head = params.get("lm_head", params["embed"])
    return layers.unembed(head, x, softcap=cfg.logits_softcap)


@torch.inference_mode()
def forward(params, cfg: ModelConfig, batch: Dict
            ) -> tuple:
    """Returns (logits (B, S, V) fp32, moe_aux = 0): the JAX signature;
    the dense family has no auxiliary loss."""
    _check_family(cfg)
    x = _embed(params, cfg, batch["tokens"])
    x = blocks.apply_stack(params["stack"], cfg, plan_for(cfg), x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), aux


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """The last position's logits (B, V) fp32 of ``forward``.

    The final norm and the unembedding run on that position only: the
    same numbers as ``forward(...)[0][:, -1]``, without (B, S, V) fp32
    logits (34 GB at S = 32768 for a 262k vocabulary)."""
    _check_family(cfg)
    x = _embed(params, cfg, batch["tokens"])
    x = blocks.apply_stack(params["stack"], cfg, plan_for(cfg), x)
    return _logits(params, cfg, x[:, -1])


# ----------------------------------------------------------- serve step ----

class DecodeState(NamedTuple):
    stack: Any                    # per-layer KV caches, stacked like params
    pos: int                      # current position (host int)


def init_decode_state(params, cfg: ModelConfig, batch_size: int,
                      cache_len: int) -> DecodeState:
    """Empty caches on the parameters' device."""
    _check_family(cfg)
    dev = params["embed"]["table"].device
    st = blocks.init_stack_state(cfg, plan_for(cfg), batch_size, cache_len,
                                 _dtype(cfg), dev)
    return DecodeState(stack=st, pos=0)


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, state, tokens (B, 1)) -> (logits (B, V), state).

    The caches are written in place: the returned state holds the same
    tensors as the one passed in, with ``pos`` advanced by one."""
    _check_family(cfg)
    plan = plan_for(cfg)

    @torch.inference_mode()
    def serve_step(params, state: DecodeState, tokens: torch.Tensor):
        x = _embed(params, cfg, tokens)
        x, stack = blocks.apply_stack_decode(params["stack"], cfg, plan, x,
                                             state.stack, state.pos)
        logits = _logits(params, cfg, x[:, 0])
        return logits, DecodeState(stack=stack, pos=state.pos + 1)

    return serve_step
