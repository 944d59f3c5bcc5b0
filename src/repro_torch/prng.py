"""Threefry-2x32 counter-based random numbers — the port's twin of
``jax.random`` as the JAX package uses it.

The layout is jax's *partitionable* threefry (``jax_threefry_partitionable``
on, the default of jax 0.9):

* a key is two uint32 words; ``PRNGKey(seed)`` is ``(0, seed mod 2**32)``
  (jax without 64-bit mode, the JAX package's setting);
* ``split(key, num)`` hashes the key over the counters ``(hi, lo)`` of the
  64-bit indices ``0 .. num-1``; new key ``i`` is the hash's two words;
* ``fold_in(key, data)`` is the hash of the counter ``(0, data)``;
* 32-bit random bits of a shape are ``y0 ^ y1`` of the hash over the
  ``(hi, lo)`` counters of each element's flat (row-major) index;
* ``uniform`` puts the top 23 bits in a float32 mantissa of [1, 2) and
  subtracts 1; ``normal`` is ``sqrt(2) * erf_inv(uniform(-1+, 1))`` with
  XLA's float32 ``erf_inv`` polynomial; ``permutation`` sorts by fresh
  32-bit keys, stably, ``ceil(3 ln n / ln(2**32 - 1))`` times.

Keys are small host-side numpy arrays (``(..., 2)`` uint32): splitting and
folding them costs a few numpy operations and no device work.  Bulk draws
(``random_bits``, ``uniform``, ``normal``, ``permutation``) run as torch
operations on the ``device`` they are given, vectorised over a stack of
keys the way the JAX package ``vmap``s them (``"cpu"`` for a host-side
draw).  The 32-bit words live in int64 tensors masked to 32 bits after
every add and shift (PyTorch has few uint32 operations and shifts int32
arithmetically).
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32 erf_inv coefficients (Giles), as XLA's ErfInv evaluates them
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

Device = Union[str, torch.device]


# ------------------------------------------------------------ the hash ----

class _NumpyWords:
    """uint32 words as numpy arrays (wrap-around adds)."""

    @staticmethod
    def add(a, b):
        return np.add(a, b, dtype=np.uint32)

    @staticmethod
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


class _TorchWords:
    """uint32 words as int64 tensors in [0, 2**32)."""

    @staticmethod
    def add(a, b):
        return (a + b) & MASK32

    @staticmethod
    def rotl(x, r):
        return ((x << r) & MASK32) | (x >> (32 - r))


def _hash(k0, k1, x0, x1, words):
    """Threefry-2x32 with 20 rounds of the counter (x0, x1) under the key
    (k0, k1), broadcast elementwise."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = words.add(x0, ks[0])
    x1 = words.add(x1, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = words.add(x0, x1)
            x1 = words.rotl(x1, r) ^ x0
        x0 = words.add(x0, ks[(i + 1) % 3])
        x1 = words.add(words.add(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def _np_hash(k0, k1, x0, x1):
    k0, k1, x0, x1 = (np.asarray(v, dtype=np.uint32) for v in (k0, k1, x0,
                                                               x1))
    k0, k1, x0, x1 = np.broadcast_arrays(k0, k1, x0, x1)
    return _hash(k0, k1, x0, x1, _NumpyWords)


def threefry2x32(key, x0, x1, device: "Device"):
    """The raw hash (Random123's threefry2x32-20) of the counters
    ``(x0, x1)`` under ``key`` (``(..., 2)``), as int64 tensors on
    ``device``."""
    key = as_key(key)
    k, x = (torch.as_tensor(np.asarray(v, np.int64), device=device)
            for v in (key.astype(np.int64), np.stack(
                np.broadcast_arrays(np.asarray(x0, np.int64),
                                    np.asarray(x1, np.int64)), -1)))
    return _hash(k[..., 0], k[..., 1], x[..., 0], x[..., 1], _TorchWords)


# ------------------------------------------------------------- keys ------

def as_key(key) -> np.ndarray:
    """A key or a stack of keys as a ``(..., 2)`` uint32 array."""
    k = np.asarray(key)
    if k.shape[-1:] != (2,):
        raise ValueError(f"a threefry key has shape (..., 2); got {k.shape}")
    if k.dtype != np.uint32:
        if not np.issubdtype(k.dtype, np.integer):
            raise TypeError(f"a threefry key is uint32; got {k.dtype}")
        k = (k.astype(np.int64) & MASK32).astype(np.uint32)
    return k


def PRNGKey(seed: int) -> np.ndarray:            # noqa: N802 (jax's name)
    """``jax.random.PRNGKey(seed)`` without 64-bit mode: (0, seed mod 2**32)."""
    return np.array([0, int(seed) & MASK32], dtype=np.uint32)


def _counters_np(num: int):
    idx = np.arange(num, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(MASK32)).astype(np.uint32))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> (num, 2) uint32."""
    key = as_key(key)
    if key.shape != (2,):
        raise ValueError("split takes one key")
    hi, lo = _counters_np(num)
    y0, y1 = _np_hash(key[0], key[1], hi, lo)
    return np.stack([y0, y1], axis=-1)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``; ``key`` (..., 2) and ``data``
    broadcast, so a stack of keys folds in one call (the per-client folds
    of the round key)."""
    key = as_key(key)
    d = (np.asarray(data, dtype=np.int64) & MASK32).astype(np.uint32)
    y0, y1 = _np_hash(key[..., 0], key[..., 1], 0, d)
    return np.stack([y0, y1], axis=-1)


# ------------------------------------------------------- bulk draws ------

def _size(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if len(shape) else 1


@functools.lru_cache(maxsize=64)
def _flat_layout(kf: int, sizes: Tuple[int, ...], device: torch.device):
    """Where each element of a leaf-major flat draw comes from: element
    ``j`` of array ``l`` under lead index ``k`` sits in block ``l``, row
    ``k``; returns per element its key's index ``k * L + l`` and the
    (hi, lo) words of its counter ``j`` (hi the int 0 when no counter
    reaches 2**32)."""
    n_arrays = len(sizes)
    lead = torch.arange(kf, dtype=torch.int64, device=device)
    key_index = torch.cat([(lead * n_arrays + li).repeat_interleave(s)
                           for li, s in enumerate(sizes)])
    ctr = torch.cat([torch.arange(s, dtype=torch.int64, device=device)
                     .repeat(kf) for s in sizes])
    hi = (ctr >> 32) if max(sizes) > (1 << 32) else 0
    return key_index, hi, ctr & MASK32


def _check_many(keys, shapes):
    keys = as_key(keys)
    shapes = [tuple(int(d) for d in s) for s in shapes]
    if keys.ndim < 2 or keys.shape[-2] != len(shapes) or not shapes:
        raise ValueError(f"keys {keys.shape} do not hold one key for each "
                         f"of {len(shapes)} arrays")
    return keys, shapes, keys.shape[:-2], tuple(_size(s) for s in shapes)


def random_bits_flat(keys, shapes: Sequence[Sequence[int]],
                     device: Device):
    """The bits of :func:`random_bits_many` on ``device`` as one flat
    int64 buffer, leaf-major (array by array, each ``(*K, *shape)`` in
    row-major order): all arrays hashed by one sequence of operations.
    Returns (bits, key index of each element into ``keys`` reshaped to
    ``(-1, 2)``)."""
    keys, shapes, lead, sizes = _check_many(keys, shapes)
    kf = _size(lead)
    dev = torch.device(device)
    key_index, hi, lo = _flat_layout(kf, sizes, dev)
    kt = torch.from_numpy(keys.reshape(-1, 2).astype(np.int64)).to(
        dev, non_blocking=True)
    y0, y1 = _hash(kt[:, 0][key_index], kt[:, 1][key_index], hi, lo,
                   _TorchWords)
    return y0 ^ y1, key_index


def _split_flat(flat, lead, shapes):
    """Views of a leaf-major flat buffer as ``(*lead, *shape)`` arrays."""
    kf = _size(lead)
    out, begin = [], 0
    for s in shapes:
        n = kf * _size(s)
        out.append(flat[begin:begin + n].view(tuple(lead) + s))
        begin += n
    return out


def random_bits_many(keys, shapes: Sequence[Sequence[int]],
                     device: Device) -> List:
    """32-bit random bits of several arrays in one pass.

    ``keys`` is ``(*K, L, 2)``: array ``l`` of ``shapes`` is drawn under
    ``keys[..., l, :]``, once per leading index, so result ``l`` has shape
    ``(*K, *shapes[l])`` and equals ``jax.random.bits(keys[k, l],
    shapes[l])`` for every k.  The bits are int64 tensors on ``device`` in
    [0, 2**32), views of one flat draw (:func:`random_bits_flat`).
    """
    keys, shapes, lead, _ = _check_many(keys, shapes)
    flat, _ = random_bits_flat(keys, shapes, device)
    return _split_flat(flat, lead, shapes)


def random_bits(key, shape: Sequence[int], device: Device):
    """``jax.random.bits(key, shape)`` (uint32) for a key or a stack of
    keys ``(*K, 2)`` -> ``(*K, *shape)``; see :func:`random_bits_many`."""
    key = as_key(key)
    return random_bits_many(key[..., None, :], [shape], device)[0]


def _bits_to_unit(bits):
    """32 random bits -> float32 in [0, 1): the top 23 bits as the mantissa
    of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _scale_unit(f, minval: float, maxval: float):
    """``max(minval, f * (maxval - minval) + minval)`` in float32 with the
    multiply-add fused, as XLA computes it: evaluated in float64, where
    the product of two float32 values is exact, and rounded once."""
    lo, hi = np.float32(minval), np.float32(maxval)
    width = float(np.float32(hi - lo))
    if width == 1.0 and lo == 0.0:
        return f
    y = (f.double() * width + float(lo)).float()
    return torch.clamp_min(y, float(lo))


def uniform_flat(keys, shapes, device: Device):
    """float32 uniforms of :func:`random_bits_flat`'s layout: (values, key
    index of each element)."""
    bits, key_index = random_bits_flat(keys, shapes, device)
    return _bits_to_unit(bits), key_index


def uniform_many(keys, shapes, device: Device, minval: float = 0.0,
                 maxval: float = 1.0) -> List:
    """float32 ``jax.random.uniform`` of several arrays in one pass (the
    key layout of :func:`random_bits_many`)."""
    keys, shapes, lead, _ = _check_many(keys, shapes)
    flat, _ = uniform_flat(keys, shapes, device)
    return _split_flat(_scale_unit(flat, minval, maxval), lead, shapes)


def uniform(key, shape: Sequence[int], device: Device,
            minval: float = 0.0, maxval: float = 1.0):
    """float32 ``jax.random.uniform(key, shape, minval=, maxval=)`` for a
    key or a stack of keys ``(*K, 2)`` -> ``(*K, *shape)``."""
    key = as_key(key)
    return uniform_many(key[..., None, :], [shape], device, minval,
                        maxval)[0]


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' single-precision polynomial) of a
    float32 tensor."""
    # log1p in float64, rounded once: the same float32 on every device and
    # thread split (torch's float32 log1p is not; a last-ulp change of w
    # near 5 switches the polynomial, ~2e-4 away)
    w = (-torch.log1p(-(x * x).double())).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    lt5 = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = torch.where(lt, lt5[i], ge5[i]) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key, shape: Sequence[int], device: Device):
    """float32 ``jax.random.normal(key, shape)``: ``sqrt(2) *
    erf_inv(uniform(key, shape, -1+, 1))``.  The bits and the uniform are
    exact; XLA's float32 ``log1p`` and its fused multiply-adds round
    differently (within 8 float32 ulps; 3 seen over 42 keys).  A draw
    whose ``w = -log1p(-u*u)`` lies within an ulp of 5, where the
    polynomial switches, can land on the other branch (~2e-4 away)."""
    u = uniform(key, shape, device, minval=_NORMAL_LO, maxval=1.0)
    return erf_inv(u) * _SQRT2


def shuffle_rounds(n: int) -> int:
    """Sorting rounds of ``jax.random.permutation`` for n elements:
    ``ceil(3 ln n / ln(2**32 - 1))`` (0 for n <= 1)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32)
                                                      .max)))


def permutation(key, n: int, device: Device) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a permutation of ``range(n)``
    as an int64 tensor on ``device``."""
    key = as_key(key)
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        sort_keys = random_bits(sub, (n,), device)
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x
