"""Explicit device selection.

Every entry point of the port takes ``device=``.  ``None`` means
``cuda``: the port is written for the card, and a CPU run must be asked
for by name (the tests do).  There is no silent fallback — asking for
``cuda`` on a host without a card raises.  ``meta`` is the abstract
device of the dry-run's traces (``launch.dryrun``: shapes and counted
cost, no data); it too is only ever asked for by name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises if the device cannot be used here.
    ``meta`` is accepted for abstract traces."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on cuda by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' "
                         f"('meta' for an abstract trace)")
    return dev
