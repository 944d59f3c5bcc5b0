"""Input shapes, abstract input specs and the per-architecture run policy
for every (arch x shape) pair: the counterpart of ``repro.launch.specs``.

The four input shapes:

  train_4k      seq=4096    global_batch=256   train_step
  prefill_32k   seq=32768   global_batch=32    prefill (forward, last logits)
  decode_32k    seq=32768   global_batch=128   serve_step (1 token, KV cache)
  long_500k     seq=524288  global_batch=1     serve_step (sub-quadratic only)

``should_run`` is the reference's skip table; ``input_specs`` and
``decode_specs`` return ``meta`` tensors (shapes and dtypes, no
allocation) where the JAX package returns ``ShapeDtypeStruct`` s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

SHAPES: Dict[str, Tuple[int, int, str]] = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# archs allowed to run the 500k decode (sub-quadratic context handling)
LONG_OK = {"xlstm-1.3b", "jamba-1.5-large-398b", "gemma3-27b"}

# at 500k, global/full-attention layers fall back to a windowed ring cache
# (Gemma-3's own long-context serving recipe)
LONG_GLOBAL_WINDOW = 32768

# whisper's decoder is text: cap decoder token length (enc frames carry seq)
AUDIO_DECODER_LEN = 512


def should_run(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and cfg.name not in LONG_OK:
        return False, ("full-attention KV at 500k is quadratic-regime; "
                       "skipped per assignment rules (DESIGN.md §4)")
    return True, ""


def _i32(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=lm.META)


def _bf16(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.bfloat16, device=lm.META)


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """Abstract batch for the train/prefill kinds (decode: decode_specs)."""
    seq, batch, _ = SHAPES[shape_name]
    if cfg.family == "vlm":
        p = cfg.num_patch_tokens
        return {"tokens": _i32(batch, seq - p),
                "patch_embeds": _bf16(batch, p, cfg.d_model)}
    if cfg.family == "audio":
        return {"tokens": _i32(batch, min(seq, AUDIO_DECODER_LEN)),
                "enc_frames": _bf16(batch, seq, cfg.d_model)}
    return {"tokens": _i32(batch, seq)}


def decode_specs(cfg: ModelConfig, shape_name: str
                 ) -> Tuple[lm.DecodeState, torch.Tensor]:
    """(abstract DecodeState, abstract one-token batch) for serve_step."""
    seq, batch, kind = SHAPES[shape_name]
    if kind != "decode":
        raise ValueError(f"{shape_name} is a {kind} shape, not decode")
    cfg_eff = effective_decode_config(cfg, shape_name)
    enc_len = min(seq, cfg.encoder_seq_cap) if cfg.is_encdec else 0
    state = lm.abstract_decode_state(cfg_eff, batch, seq, enc_len=enc_len)
    return state, _i32(batch, 1)


def effective_decode_config(cfg: ModelConfig, shape_name: str
                            ) -> ModelConfig:
    """At 500k, global/full attention layers switch to a windowed ring KV
    (Gemma-3 long-context recipe; applies to gemma3 + jamba's attn
    layers)."""
    if shape_name == "long_500k" and cfg.name in LONG_OK:
        return dataclasses.replace(
            cfg, long_context_global_window=LONG_GLOBAL_WINDOW)
    return cfg


@dataclasses.dataclass(frozen=True)
class ArchRunPolicy:
    """Per-arch knobs: optimizer, microbatching and sharding-rule
    overrides (``models.sharding.set_rules``), the reference's values."""
    optimizer: str = "adamw"
    num_microbatches: int = 1
    rules: Optional[Dict[str, str]] = None


RUN_POLICY: Dict[str, ArchRunPolicy] = {
    "nemotron-4-340b": ArchRunPolicy(optimizer="adafactor",
                                     num_microbatches=16,
                                     rules={"residual": "model",
                                            "seq_act": "data"}),
    "jamba-1.5-large-398b": ArchRunPolicy(optimizer="adafactor",
                                          num_microbatches=8,
                                          rules={"residual": "model"}),
    "gemma3-27b": ArchRunPolicy(num_microbatches=8),
    "pixtral-12b": ArchRunPolicy(num_microbatches=8),
    "qwen3-moe-30b-a3b": ArchRunPolicy(num_microbatches=8),
    "whisper-medium": ArchRunPolicy(num_microbatches=4),
    "chatglm3-6b": ArchRunPolicy(num_microbatches=4),
    "granite-3-8b": ArchRunPolicy(num_microbatches=8),
    "granite-moe-1b-a400m": ArchRunPolicy(num_microbatches=8),
    "xlstm-1.3b": ArchRunPolicy(num_microbatches=4),
}


def policy_for(cfg: ModelConfig) -> ArchRunPolicy:
    return RUN_POLICY.get(cfg.name, ArchRunPolicy())
