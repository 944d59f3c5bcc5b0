"""pixtral-12b [vlm] — Pixtral-ViT frontend (STUB) + Mistral-Nemo decoder.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
[hf:mistralai/Pixtral-12B-2409]
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=131072,
        activation="swiglu", norm="rmsnorm",
        rope="1d", rope_theta=1_000_000_000.0,
        num_patch_tokens=256,           # stub ViT patch embeddings prefix
        tie_embeddings=False,
        source="hf:mistralai/Pixtral-12B-2409",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, num_patch_tokens=8)
