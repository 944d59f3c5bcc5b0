"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.  [arXiv:2403.19887]

Block layout per Jamba: period-8 super-blocks with ONE attention layer and
seven Mamba layers; MoE replaces the dense FFN on every second layer
(MoEConfig.every=2).
"""

import dataclasses

from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=24576, vocab_size=65536,
        activation="swiglu", norm="rmsnorm",
        rope="none",                   # Jamba attention layers are NoPE
        block_pattern=("mamba", "attn") + ("mamba",) * 6,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                      capacity_factor=1.25, every=2),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        tie_embeddings=False,
        source="arXiv:2403.19887 (Jamba-1.5)",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512,
        block_pattern=("mamba", "attn", "mamba", "mamba"),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256, every=2),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2))
