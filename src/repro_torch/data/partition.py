"""Client data partitions — a numpy copy of ``repro.data.partition``.

  IID        every class uniformly across clients: equal shards (up to
             one sample), the stackable data of a vmapped trainer
  Non-IID-a  each client holds a random number (2..C) of classes
  Non-IID-b  each client holds exactly 3 random classes (paper §6.1)
  Dirichlet  standard Dir(alpha) label-skew partition
  class-imbalanced  a global dataset with rare classes (paper §6.7)

Returns a list of index arrays (one per client), equal to the JAX
package's for the same seed.
"""

from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.synthetic import SyntheticImageDataset


def _split_among(idx: np.ndarray, owners: List[int], rng,
                 parts: List[List[int]]):
    rng.shuffle(idx)
    chunks = np.array_split(idx, len(owners))
    for o, ch in zip(owners, chunks):
        parts[o].extend(ch.tolist())


def partition_iid(ds: SyntheticImageDataset, num_clients: int,
                  seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = np.arange(len(ds))
    rng.shuffle(idx)
    return [np.sort(a) for a in np.array_split(idx, num_clients)]


def _partition_by_classes(ds, num_clients, classes_per_client, seed):
    rng = np.random.default_rng(seed)
    c = ds.num_classes
    client_classes = [rng.choice(c, size=k, replace=False)
                      for k in classes_per_client]
    parts: List[List[int]] = [[] for _ in range(num_clients)]
    for cls in range(c):
        owners = [i for i in range(num_clients)
                  if cls in client_classes[i]]
        if not owners:   # ensure every class is held somewhere
            owners = [int(rng.integers(num_clients))]
        idx = np.where(ds.y == cls)[0].copy()
        _split_among(idx, owners, rng, parts)
    return [np.sort(np.asarray(p, np.int64)) for p in parts]


def partition_noniid_a(ds: SyntheticImageDataset, num_clients: int,
                       seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    ks = rng.integers(2, ds.num_classes + 1, num_clients)
    return _partition_by_classes(ds, num_clients, ks.tolist(), seed + 1)


def partition_noniid_b(ds: SyntheticImageDataset, num_clients: int,
                       seed: int = 0) -> List[np.ndarray]:
    return _partition_by_classes(ds, num_clients, [3] * num_clients, seed)


def partition_dirichlet(ds: SyntheticImageDataset, num_clients: int,
                        alpha: float = 0.5, seed: int = 0
                        ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    parts: List[List[int]] = [[] for _ in range(num_clients)]
    for cls in range(ds.num_classes):
        idx = np.where(ds.y == cls)[0].copy()
        rng.shuffle(idx)
        p = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(p)[:-1] * len(idx)).astype(int)
        for o, ch in enumerate(np.split(idx, cuts)):
            parts[o].extend(ch.tolist())
    return [np.sort(np.asarray(p, np.int64)) for p in parts]


def partition_class_imbalanced(ds: SyntheticImageDataset, num_clients: int,
                               rare_classes=(0, 1, 2),
                               rare_ratio: float = 0.4,
                               seed: int = 0) -> List[np.ndarray]:
    """Paper §6.7: rare classes keep only ``rare_ratio`` of their samples
    globally; clients then get 3 random classes each (as Non-IID-b)."""
    rng = np.random.default_rng(seed)
    keep = []
    for cls in range(ds.num_classes):
        idx = np.where(ds.y == cls)[0]
        if cls in rare_classes:
            idx = rng.choice(idx, size=int(len(idx) * rare_ratio),
                             replace=False)
        keep.extend(idx.tolist())
    keep = np.sort(np.asarray(keep))
    sub = ds.subset(keep)
    parts_local = partition_noniid_b(sub, num_clients, seed + 1)
    return [keep[p] for p in parts_local]


def label_distribution(ds: SyntheticImageDataset, idx: np.ndarray
                       ) -> np.ndarray:
    """dis_n^c — proportion of each label in a client's shard."""
    counts = np.bincount(ds.y[idx], minlength=ds.num_classes).astype(float)
    return counts / max(counts.sum(), 1.0)


def label_coverage_score(ds: SyntheticImageDataset, idx: np.ndarray
                         ) -> float:
    """sum_c min(C * dis_n^c, 1) — the Eq. (13) data-distribution term."""
    c = ds.num_classes
    dis = label_distribution(ds, idx)
    return float(np.sum(np.minimum(c * dis, 1.0)))
