"""Coverage rates CR(k) for heterogeneous client models — FedDD §4.2.

When clients run sub-models pruned from a common full model (same layer
structure, fewer channels), channel ``k`` of the full model is *covered*
by client ``n`` iff ``k < width_n(layer)``.  The server computes
CR(k) = (#clients covering k) / N from the clients' widths, and the FedDD
importance divides by it (Eq. (21)), so rarely covered channels are
uploaded by the few clients that hold them.

Layers are named by their ``tree.keystr`` path (``"['fc0']['w']"``), the
names of ``jax.tree_util.keystr``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch import tree


def _width(leaf, channel_axis: int) -> int:
    return (int(leaf.shape[channel_axis % leaf.ndim]) if leaf.ndim > 0
            else 1)


def channel_widths(params, channel_axis: int = -1) -> Dict[str, int]:
    """Leaf path -> channel count of a parameter pytree."""
    return {tree.keystr(path): _width(leaf, channel_axis)
            for path, leaf in tree.flatten_with_path(params)[0]}


def coverage_rates(client_widths: Sequence[Dict[str, int]],
                   full_widths: Dict[str, int]) -> Dict[str, np.ndarray]:
    """CR per layer: a (full_width,) float32 array of the fraction of
    clients whose sub-model holds each channel (a client without the
    layer covers none of it)."""
    n = len(client_widths)
    out = {}
    for name, full_w in full_widths.items():
        counts = np.zeros(full_w, np.float32)
        for cw in client_widths:
            counts[: min(cw.get(name, 0), full_w)] += 1.0
        out[name] = counts / max(n, 1)
    return out


def coverage_pytree(params, cr_by_name: Dict[str, np.ndarray],
                    channel_axis: int = -1):
    """A pytree shaped like ``params`` whose leaves are the client's slice
    of the coverage arrays, (local_channels,) float32 on the params'
    device; a layer missing from ``cr_by_name`` gets ones."""
    pairs, treedef = tree.flatten_with_path(params)
    out = []
    for path, leaf in pairs:
        nch = _width(leaf, channel_axis)
        cr = cr_by_name.get(tree.keystr(path))
        out.append(torch.ones(nch, dtype=torch.float32, device=leaf.device)
                   if cr is None else
                   torch.as_tensor(np.asarray(cr[:nch], np.float32),
                                   device=leaf.device))
    return tree.unflatten(treedef, out)
