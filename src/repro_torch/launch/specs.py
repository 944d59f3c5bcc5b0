"""Per-architecture run policy: the optimizer and microbatch count each
architecture trains with (the JAX package's ``repro.launch.specs``
``ArchRunPolicy``; its dry-run input specs wait for ROADMAP A15 item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchRunPolicy:
    """Per-arch knobs: optimizer and microbatching."""
    optimizer: str = "adamw"
    num_microbatches: int = 1


RUN_POLICY: Dict[str, ArchRunPolicy] = {
    "nemotron-4-340b": ArchRunPolicy(optimizer="adafactor",
                                     num_microbatches=16),
    "jamba-1.5-large-398b": ArchRunPolicy(optimizer="adafactor",
                                          num_microbatches=8),
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
