"""Batching pipeline — a numpy copy of ``repro.data.pipeline``:
deterministic, epoch-shuffled minibatch iterators over client shards and
a packed-sequence LM batcher.  Every batch equals the JAX package's for
the same arguments."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.data.synthetic import SyntheticImageDataset


@dataclasses.dataclass
class BatchIterator:
    """Epoch-shuffled minibatches over one client's shard.

    Deterministic given (seed, epoch): reshuffles at every epoch boundary;
    the final short batch is dropped (the paper's per-epoch SGD).
    """
    x: np.ndarray
    y: np.ndarray
    batch_size: int
    seed: int = 0

    def __post_init__(self):
        if len(self.x) != len(self.y):
            raise ValueError("x/y length mismatch")

    def epoch(self, epoch_idx: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed + 1000 * epoch_idx)
        idx = rng.permutation(len(self.x))
        n_full = len(idx) // self.batch_size
        for i in range(n_full):
            sl = idx[i * self.batch_size:(i + 1) * self.batch_size]
            yield self.x[sl], self.y[sl]

    def steps_per_epoch(self) -> int:
        return len(self.x) // self.batch_size


def client_iterators(ds: SyntheticImageDataset, parts, batch_size: int,
                     *, flatten: bool = False, seed: int = 0):
    """One BatchIterator per client shard."""
    its = []
    for ci, p in enumerate(parts):
        x = ds.x[p]
        if flatten:
            x = x.reshape(len(p), -1)
        its.append(BatchIterator(x, ds.y[p], batch_size, seed=seed + ci))
    return its


@dataclasses.dataclass
class PackedLMBatcher:
    """Fixed-length LM batches from a token stream."""
    tokens: np.ndarray            # (N,) int32
    seq_len: int
    batch_size: int
    seed: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + step)
        starts = rng.integers(0, len(self.tokens) - self.seq_len - 1,
                              self.batch_size)
        return {"tokens": np.stack([self.tokens[s:s + self.seq_len]
                                    for s in starts])}
