"""gemma3-27b [dense] — 5:1 local:global attention, 128k context, qk-norm.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
[hf:google/gemma-3-27b-pt (family card: google/gemma-3-1b-pt)]

long_500k runs for this arch: 51 of 62 layers use a 1024-token sliding
window; the ~10 global layers use windowed KV for the 500k decode shape per
Gemma-3's own long-context serving recipe (DESIGN.md §4).
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16,
        head_dim=128, d_ff=21504, vocab_size=262144,
        activation="geglu", norm="rmsnorm", qk_norm=True,
        rope="1d", rope_theta=1_000_000.0,
        local_global_ratio=(5, 1), window_size=1024,
        tie_embeddings=True, embed_scale=True,
        source="hf:google/gemma-3-1b-pt (gemma-3 family)",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, window_size=16,
        local_global_ratio=(1, 1))
