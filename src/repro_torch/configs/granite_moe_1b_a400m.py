"""granite-moe-1b-a400m [moe] — 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff(expert)=512 vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""

import dataclasses

from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
        head_dim=64, d_ff=512, vocab_size=49155,
        activation="swiglu", norm="rmsnorm",
        rope="1d", rope_theta=10_000.0,
        moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512,
                      capacity_factor=1.25),
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128))
