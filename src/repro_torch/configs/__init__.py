"""Architecture registry of the port, with the JAX registry's names.

``get_config(name, reduced=False)`` takes the same ids and hyphenated
aliases as ``repro.configs`` and gives the same configs: the dense
family (gemma3_27b, granite_3_8b, chatglm3_6b, nemotron_4_340b), MoE
(qwen3_moe_30b_a3b, granite_moe_1b_a400m), the hybrid
jamba_1p5_large_398b, the xLSTM xlstm_1p3b, the VLM pixtral_12b and the
enc-dec audio model whisper_medium.  ``reduced=True`` picks each one's
smoke-test variant.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "pixtral_12b",
    "chatglm3_6b",
    "qwen3_moe_30b_a3b",
    "jamba_1p5_large_398b",
    "granite_3_8b",
    "xlstm_1p3b",
    "gemma3_27b",
    "whisper_medium",
    "nemotron_4_340b",
    "granite_moe_1b_a400m",
]

ALIASES = {
    "pixtral-12b": "pixtral_12b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "granite-3-8b": "granite_3_8b",
    "xlstm-1.3b": "xlstm_1p3b",
    "gemma3-27b": "gemma3_27b",
    "whisper-medium": "whisper_medium",
    "nemotron-4-340b": "nemotron_4_340b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
}


def list_configs() -> List[str]:
    return list(ARCH_IDS)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; one of {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced() if reduced else mod.config()
