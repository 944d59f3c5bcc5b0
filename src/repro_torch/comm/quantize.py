"""Value codecs for the kept upload payload — fp32 / fp16 / int8-SR.

The port's copy of ``repro.comm.quantize``:

* ``qbits=32`` — lossless, the identity; 4 bytes a value;
* ``qbits=16`` — an IEEE fp16 cast round trip; 2 bytes a value;
* ``qbits=8``  — symmetric int8 with stochastic rounding: per leaf,
  ``scale = max|x| / 127`` and ``q = clip(floor(x / scale + u), -127,
  127)`` with ``u ~ U[0, 1)`` drawn by threefry (:mod:`repro_torch.prng`)
  from an explicit key; 1 byte a value plus a 4-byte scale per leaf
  (charged with the mask framing, ``codecs.mask_overhead_bytes*``).

Keys follow the JAX package: ``fold_in(round_key, 20_000 + i)`` for
client ``i`` (masks use 10_000 + i), then ``fold_in(client_key, leaf)``
in flatten order, so the same client and leaf draw the same noise on
every path.  The scale is ``max|x| * float32(1/127)``, as the JAX
package's jitted engine computes ``max|x| / 127``, or with
``exact_scale`` the true quotient its eager per-client loop computes;
``x / scale`` divides by a tensor (CUDA divides by a Python scalar
through its reciprocal, an ulp off the true quotient, which could move a
code).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import prng, tree

QBITS = (32, 16, 8)

# PRNG fold namespace of quantization keys (masks use 10_000 + i)
QKEY_OFFSET = 20_000
# max|x| / 127 as the JAX package's jitted engine computes it: XLA folds a
# division by a compile-time constant into a multiply by its float32
# reciprocal (its eager ops divide exactly, an ulp away at ~4% of values);
# a float32 tensor times this Python float multiplies by that float32
_INV_127 = float(np.float32(1.0 / 127.0))


def value_bytes(qbits: int) -> int:
    """Bytes per surviving parameter value."""
    if qbits not in QBITS:
        raise ValueError(f"qbits must be one of {QBITS}, got {qbits}")
    return qbits // 8


def scale_bytes(qbits: int) -> int:
    """Per-leaf framing bytes of the value codec (int8 ships a scale)."""
    return 4 if qbits == 8 else 0


def quantize_leaf(x: torch.Tensor, qbits: int, key=None, *,
                  exact_scale: bool = False):
    """Encode one leaf -> (codes, scale): fp32/fp16 codes are the values
    in the target dtype (scale None); int8 codes are the stochastically
    rounded integers, with a 0-d float32 scale (``exact_scale``: the true
    quotient ``max|x| / 127``, else the reciprocal product)."""
    if qbits == 32:
        return x.to(torch.float32), None
    if qbits == 16:
        return x.to(torch.float16), None
    if key is None:
        raise ValueError("qbits=8 stochastic rounding requires a PRNG key")
    xf = x.to(torch.float32)
    u = prng.uniform(key, tuple(xf.shape), xf.device)
    amax = xf.abs().amax()
    scale = (amax / torch.full((), 127.0, device=xf.device) if exact_scale
             else amax * _INV_127)
    q = torch.clamp(torch.floor(xf / torch.clamp_min(scale, 1e-30) + u),
                    -127, 127)
    return q.to(torch.int8), scale


def dequantize_leaf(codes: torch.Tensor, scale: Optional[torch.Tensor],
                    qbits: int) -> torch.Tensor:
    if qbits in (32, 16):
        return codes.to(torch.float32)
    return torch.where(scale > 0, codes.to(torch.float32) * scale,
                       torch.zeros((), device=codes.device))


def qdq_leaf(x: torch.Tensor, qbits: int, key=None, *,
             exact_scale: bool = False) -> torch.Tensor:
    """quantize -> dequantize one leaf (what the server's aggregate sees),
    in ``x``'s dtype; the identity for qbits=32."""
    if qbits == 32:
        return x
    codes, scale = quantize_leaf(x, qbits, key, exact_scale=exact_scale)
    return dequantize_leaf(codes, scale, qbits).to(x.dtype)


def quantize_dequantize(params, key, qbits: int, *,
                        exact_scale: bool = False):
    """One client's QDQ over a pytree, leaf ``l`` under
    ``fold_in(key, l)`` in flatten order.  ``exact_scale`` renders the
    JAX package's eager per-client loop (a true ``max|x| / 127``); the
    default equals :func:`quantize_dequantize_stacked` row by row."""
    if qbits == 32:
        return params
    leaves, treedef = tree.flatten(params)
    out = [qdq_leaf(l, qbits,
                    prng.fold_in(key, i) if key is not None else None,
                    exact_scale=exact_scale)
           for i, l in enumerate(leaves)]
    return tree.unflatten(treedef, out)


def client_quant_key(round_key, client_index):
    """Client ``i``'s quantization key: fold_in(round_key, 20_000 + i)."""
    return prng.fold_in(round_key, QKEY_OFFSET + np.asarray(client_index))


def quantize_dequantize_stacked(stacked, rng, qbits: int,
                                client_indices=None):
    """Client-stacked QDQ: leaves (N, *leaf) -> the same, with client
    ``i``'s leaf ``l`` under ``fold_in(fold_in(rng, 20_000 + i), l)`` —
    equal to :func:`quantize_dequantize` client by client (the scale is a
    max, exact in any order; the rest is elementwise).  All the int8
    noise of the tree is drawn in one pass.  ``client_indices`` are the
    (N,) host ids ``i`` of the rows (default ``arange(N)``): a shape
    group passes its members' fleet positions, as for its masks.
    """
    if qbits == 32:
        return stacked
    leaves, treedef = tree.flatten(stacked)
    if qbits == 16:
        return tree.unflatten(treedef, [qdq_leaf(l, qbits) for l in leaves])
    if rng is None:
        raise ValueError("qbits=8 stochastic rounding requires a PRNG key")
    n = leaves[0].shape[0]
    ids = (np.arange(n) if client_indices is None
           else np.asarray(client_indices, np.int64))
    client_keys = client_quant_key(rng, ids)                 # (N, 2)
    keys = prng.fold_in(client_keys[:, None, :], np.arange(len(leaves)))
    # one leaf-major flat pass: the noise, the values, a scale per (client,
    # leaf) segment, the codes
    u, seg = prng.uniform_flat(keys, [tuple(l.shape[1:]) for l in leaves],
                               leaves[0].device)
    xf = torch.cat([l.reshape(-1).float() for l in leaves])
    ax = xf.abs()
    amax, begin = [], 0
    for l in leaves:             # a (client, leaf) segment is one row here
        amax.append(ax[begin:begin + l.numel()].view(n, -1).amax(dim=1))
        begin += l.numel()
    # segment k * L + l: client k's leaf l (the noise's key index)
    scale = (torch.stack(amax, dim=1).reshape(-1) * _INV_127)[seg]
    q = torch.clamp(torch.floor(xf / torch.clamp_min(scale, 1e-30) + u),
                    -127, 127)
    deq = torch.where(scale > 0, q * scale, torch.zeros((), device=xf.device))
    out, begin = [], 0
    for l in leaves:
        out.append(deq[begin:begin + l.numel()].view(l.shape).to(l.dtype))
        begin += l.numel()
    return tree.unflatten(treedef, out)
