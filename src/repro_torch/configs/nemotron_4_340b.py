"""nemotron-4-340b [dense] — GQA kv=8, squared-ReLU MLP.

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.  [arXiv:2402.16819]
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
        head_dim=192, d_ff=73728, vocab_size=256000,
        activation="squared_relu", norm="layernorm",
        rope="1d", rotary_pct=0.5,      # nemotron uses partial rotary
        tie_embeddings=False,
        source="arXiv:2402.16819 (Nemotron-4 340B)",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=384, num_heads=4, num_kv_heads=2,
        head_dim=96, d_ff=768, vocab_size=512)
