"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM).

48L d_model=2048 4H d_ff=0 (blocks have internal projections) vocab=50304.
[arXiv:2405.04517]
"""

import dataclasses

from repro_torch.models.config import ModelConfig, XLSTMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        activation="swiglu", norm="rmsnorm",
        rope="none",
        block_pattern=("mlstm",) * 7 + ("slstm",),
        xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, chunk_size=256),
        tie_embeddings=True,
        source="arXiv:2405.04517 (xLSTM)",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        vocab_size=512, block_pattern=("mlstm", "slstm"),
        xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0, chunk_size=32))
