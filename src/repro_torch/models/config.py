"""Model configuration: the JAX package's ``repro.models.config``, copied.

One dataclass covers every architecture family of the registry (dense /
moe / hybrid / ssm / vlm / audio).  A config fully determines the per-layer
*layout*: an explicit list of ``BlockSpec`` entries (one per layer) naming
the mixer (attention / mamba / mlstm / slstm) and the feed-forward type
(dense / moe / none).  ``layout_period`` finds the smallest repeating unit:
the stack's parameters are stacked per position of that unit, with a
leading ``n_super`` axis, exactly as the JAX package stacks them, so
parameter trees carry across leaf for leaf.

Pure Python: this module imports nothing but the standard library.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01     # load-balance loss weight
    every: int = 1                    # MoE layer every k-th layer (jamba: 2)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None     # default ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8              # one sLSTM block per this many layers
    proj_factor: float = 2.0          # up-projection factor inside blocks
    chunk_size: int = 256             # chunkwise-parallel mLSTM chunk


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer's composition."""
    mixer: str                        # attn | attn_local | mamba | mlstm | slstm
    ff: str                           # dense | moe | none
    cross_attention: bool = False     # decoder layers of enc-dec models
    window: Optional[int] = None      # attn_local sliding-window width


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|hybrid|ssm|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // num_heads
    activation: str = "swiglu"        # swiglu|gelu|squared_relu|geglu
    norm: str = "rmsnorm"             # rmsnorm|layernorm
    qk_norm: bool = False
    rope: str = "1d"                  # none|1d|2d(partial rotary)
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0           # fraction of head_dim rotated (2d: 0.5)
    window_size: int = 1024           # sliding-window width for attn_local
    local_global_ratio: Optional[Tuple[int, int]] = None  # e.g. (5,1) gemma3
    block_pattern: Optional[Tuple[str, ...]] = None  # e.g. ('attn',)+('mamba',)*7
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # enc-dec (audio):
    encoder_layers: int = 0
    encoder_seq_cap: int = 1500       # whisper's native frame budget (noted)
    # vlm:
    num_patch_tokens: int = 0         # prepended patch-embedding tokens
    # long-context serving: when set, global/full attention layers run as
    # sliding-window (ring KV) with this width — Gemma-3-style windowed
    # global KV for the 500k decode shape (DESIGN.md §4).
    long_context_global_window: Optional[int] = None
    tie_embeddings: bool = True
    embed_scale: bool = False         # gemma-style sqrt(d) embedding scale
    logits_softcap: float = 0.0       # gemma-style tanh soft-capping
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # source citation (paper / model card) — required by the assignment:
    source: str = ""

    def __post_init__(self):
        if self.family not in ("dense", "moe", "hybrid", "ssm", "vlm", "audio"):
            raise ValueError(f"bad family {self.family}")
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    # ---- layout -------------------------------------------------------------

    def layout(self) -> List[BlockSpec]:
        """Explicit per-layer block layout for the decoder stack."""
        specs: List[BlockSpec] = []
        for i in range(self.num_layers):
            mixer = self._mixer_at(i)
            ff = self._ff_at(i, mixer)
            window = None
            if mixer == "attn_local":
                window = self.window_size
            elif mixer == "attn" and self.long_context_global_window:
                mixer = "attn_local"
                window = self.long_context_global_window
            specs.append(BlockSpec(mixer=mixer, ff=ff,
                                   cross_attention=self.is_encdec,
                                   window=window))
        return specs

    def encoder_layout(self) -> List[BlockSpec]:
        return [BlockSpec(mixer="attn", ff="dense")
                for _ in range(self.encoder_layers)]

    def _mixer_at(self, i: int) -> str:
        if self.block_pattern is not None:
            return self.block_pattern[i % len(self.block_pattern)]
        if self.local_global_ratio is not None:
            l, g = self.local_global_ratio
            return "attn_local" if (i % (l + g)) < l else "attn"
        return "attn"

    def _ff_at(self, i: int, mixer: str) -> str:
        if mixer in ("mlstm", "slstm"):
            return "none"             # xLSTM blocks have internal projections
        if self.moe is not None and (i % self.moe.every) == (self.moe.every - 1):
            return "moe"
        return "dense"


def layout_period(specs: Sequence[BlockSpec]) -> int:
    """Smallest p such that specs is (a prefix of) a p-periodic sequence."""
    n = len(specs)
    for p in range(1, n + 1):
        if all(specs[i] == specs[i % p] for i in range(n)):
            return p
    return n


def split_layout(specs: Sequence[BlockSpec]) -> Tuple[List[BlockSpec], int, List[BlockSpec]]:
    """Returns (period_specs, num_superblocks, remainder_specs).

    The stack runs the period ``num_superblocks`` times (a loop over the
    stacked axis) followed by the remainder layers (always < period).
    """
    n = len(specs)
    p = layout_period(specs)
    if p == n:                         # aperiodic — look for periodic prefix
        # try small periods over the longest prefix they cover
        best = (n, 1, [])              # (period, count, remainder)
        for cand in range(1, min(12, n) + 1):
            k = 0
            while (k + 1) * cand <= n and all(
                    specs[k * cand + j] == specs[j] for j in range(cand)):
                k += 1
            covered = k * cand
            if k >= 2 and covered > best[0] * best[1]:
                best = (cand, k, list(specs[covered:]))
        if best[1] >= 2:
            return list(specs[:best[0]]), best[1], best[2]
        return list(specs), 1, []
    n_super = n // p
    rem = list(specs[n_super * p:])
    return list(specs[:p]), n_super, rem
