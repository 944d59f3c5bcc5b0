"""chatglm3-6b [dense] — RoPE-2d (partial rotary), GQA kv=2.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.  [arXiv:2406.12793]
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
        head_dim=128, d_ff=13696, vocab_size=65024,
        activation="swiglu", norm="rmsnorm",
        rope="2d", rotary_pct=0.5,       # GLM applies rotary to half the dim
        tie_embeddings=False,
        source="arXiv:2406.12793 (ChatGLM family), hf:THUDM/chatglm3-6b",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512)
