"""Uplink byte accounting — the default wire format of ``repro.comm``.

The default :class:`CommConfig` (dense codec, 32-bit values) is the
analytic accounting: an upload costs ``density x model_bytes`` and the
wire carries nothing else.  The sparse mask codecs and value quantization
are not ported yet (ROADMAP.md queue A item 9); asking for them raises.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CommConfig:
    codec: str = "dense"
    qbits: int = 32

    def __post_init__(self):
        if self.codec != "dense" or self.qbits != 32:
            raise NotImplementedError(
                f"wire format codec={self.codec!r}, qbits={self.qbits} is "
                "not ported yet (ROADMAP.md queue A item 9); the port "
                "supports the default dense/32-bit accounting only")


def uplink_bytes_raw(densities, participants, model_bytes) -> float:
    """sum_n density_n * U_n over the round's uploaders."""
    d = np.asarray(densities, np.float64)
    p = np.asarray(participants, np.float64)
    return float(np.dot(d * p, np.asarray(model_bytes, np.float64)))


def account_uplink(densities, participants, model_bytes,
                   comm: CommConfig = CommConfig()) -> Tuple[float, float]:
    """(uploaded_bytes, wire_bytes) for one round; equal for the default
    wire format, which is the only one ported."""
    raw = uplink_bytes_raw(densities, participants, model_bytes)
    return raw, raw
