"""granite-3-8b [dense] — GQA kv=8.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base (family card)]
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b", family="dense",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=12800, vocab_size=49155,
        activation="swiglu", norm="rmsnorm",
        rope="1d", rope_theta=10_000_000.0,
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-8b-base",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=515)   # keep odd vocab on purpose
