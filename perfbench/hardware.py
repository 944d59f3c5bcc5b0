"""Peaks of the card, NVIDIA's data sheet for the H100 SXM (dense, no
sparsity, at its 700 W limit).  FedDD's models train in float32 with
TF32 off, so their FLOP peak is the float32 rate outside the tensor
cores."""

from __future__ import annotations

import subprocess
from typing import Dict

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}


def peaks(kind: str) -> Dict[str, float]:
    """The peaks of the card named ``kind``; an H100 by another name (a
    PCIe part is slower, so its shares read low, never high) takes the
    SXM figures."""
    return PEAKS.get(kind, PEAKS["NVIDIA H100 80GB HBM3"])


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or ''."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
