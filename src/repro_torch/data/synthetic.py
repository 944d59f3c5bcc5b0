"""Synthetic datasets — a numpy copy of ``repro.data.synthetic``.

``make_dataset`` builds a Gaussian-mixture image-classification set whose
shapes match the paper's datasets (mnist/fmnist-like ``(28, 28, 1)``,
cifar10-like ``(32, 32, 3)``, 10 classes): each class is a mixture of
anisotropic Gaussians over a low-dimensional latent space projected
through a fixed random linear map + tanh.  The arrays are equal, element
for element, to the JAX package's for the same arguments.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticImageDataset:
    x: np.ndarray        # (N, H, W, C) float32 in [-1, 1]
    y: np.ndarray        # (N,) int32
    num_classes: int
    name: str

    def __len__(self) -> int:
        return len(self.y)

    def subset(self, idx: np.ndarray) -> "SyntheticImageDataset":
        return SyntheticImageDataset(self.x[idx], self.y[idx],
                                     self.num_classes, self.name)


_SHAPES = {
    "mnist": (28, 28, 1),
    "fmnist": (28, 28, 1),
    "cifar10": (32, 32, 3),
}


def make_dataset(name: str, *, num_train: int = 20_000,
                 num_test: int = 4_000, num_classes: int = 10,
                 latent_dim: int = 32, modes_per_class: int = 3,
                 class_sep: float = 3.2, noise: float = 0.9,
                 seed: int = 0) -> Tuple[SyntheticImageDataset,
                                         SyntheticImageDataset]:
    """Returns (train, test)."""
    if name not in _SHAPES:
        raise ValueError(f"unknown dataset {name!r}; options {list(_SHAPES)}")
    h, w, c = _SHAPES[name]
    d_out = h * w * c
    # crc32, not hash(): str hash is salted per process (PYTHONHASHSEED)
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2 ** 16))
    proj = rng.normal(0, 1.0 / np.sqrt(latent_dim), (latent_dim, d_out))
    centers = rng.normal(0, class_sep,
                         (num_classes, modes_per_class, latent_dim))

    def _sample(n: int, seed_off: int):
        r = np.random.default_rng(seed + seed_off)
        y = r.integers(0, num_classes, n).astype(np.int32)
        mode = r.integers(0, modes_per_class, n)
        z = centers[y, mode] + r.normal(0, noise, (n, latent_dim))
        x = np.tanh(z @ proj).astype(np.float32).reshape(n, h, w, c)
        return x, y

    xtr, ytr = _sample(num_train, 1)
    xte, yte = _sample(num_test, 2)
    return (SyntheticImageDataset(xtr, ytr, num_classes, name),
            SyntheticImageDataset(xte, yte, num_classes, name))


def make_lm_dataset(*, vocab_size: int, num_tokens: int = 1 << 20,
                    order: int = 2, seed: int = 0) -> np.ndarray:
    """Synthetic token stream with Markov structure (so an LM has something
    to learn); used by the LM train and federated-pods drivers.  Equal,
    token for token, to the JAX package's."""
    rng = np.random.default_rng(seed)
    # sparse bigram transition structure
    fanout = min(32, vocab_size)
    nxt = rng.integers(0, vocab_size, (vocab_size, fanout))
    toks = np.empty(num_tokens, np.int32)
    t = rng.integers(0, vocab_size)
    for i in range(num_tokens):
        toks[i] = t
        t = nxt[t, rng.integers(0, fanout)]
    return toks
