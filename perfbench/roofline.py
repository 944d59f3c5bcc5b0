"""A kernel's share of its roofline: the least time the card needs for
the work the traced rounds asked of it (bytes over the HBM bandwidth;
every kernel here is bound by bytes) over the device time of the kernels
whose names the metric lists.  The bytes come from the cell's leaf
shapes, so they read the same work whatever implements it."""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

F32 = 4


def elements(shape) -> int:
    return math.prod(shape)


def share(run, names: Sequence[str], traced_bytes: float) -> Optional[float]:
    """100 x bound / device time of the named kernels in the traced
    window; None where none ran or no trace was taken."""
    if run.trace is None:
        return None
    pattern = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    kernels = [k for k in run.trace.kernels_in_window()
               if pattern.search(k[0])]
    seconds = run.trace.kernel_seconds(kernels)
    if not kernels or seconds <= 0 or traced_bytes <= 0:
        return None
    return 100.0 * traced_bytes / run.peaks["hbm_bytes_s"] / seconds
