"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, GQA kv=4, qk-norm.

48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768 vocab=151936.
[hf:Qwen/Qwen3-30B-A3B]
"""

import dataclasses

from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151936,
        activation="swiglu", norm="rmsnorm", qk_norm=True,
        rope="1d", rope_theta=1_000_000.0,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768,
                      capacity_factor=1.25),
        tie_embeddings=False,
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128))
