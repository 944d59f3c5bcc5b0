"""whisper-medium [audio] — encoder-decoder; mel+conv frontend is a STUB
(input_specs provides frame embeddings).

24L decoder + 24L encoder, d_model=1024 16H d_ff=4096 vocab=51865.
[arXiv:2212.04356]
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, vocab_size=51865,
        activation="gelu", norm="layernorm",
        rope="none",                    # absolute sinusoidal positions
        encoder_layers=24, encoder_seq_cap=1500,
        tie_embeddings=True,
        source="arXiv:2212.04356 (Whisper)",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        d_ff=512, vocab_size=512, encoder_layers=2)
