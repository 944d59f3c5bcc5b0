"""System-heterogeneity sampler — the paper's Table 4 simulation settings.

  r_u  ~ U[1, 5]  x 10^4 bit/s        uplink
  r_d  ~ U[4, 20] x 10^4 bit/s        downlink
  f_n  ~ U[1, 10] GHz                 CPU frequency
  c_n  ~ U[1, 10] Megacycles/sample   per-sample cycles

t_cmp = c_n * b_n / f_n  (Eq. (7)) with b_n = the client's shard size x
local epochs.  Same draws as ``repro.fl.heterogeneity`` for the same seed.

Also the shape groups of a ragged (model-heterogeneous) fleet: clients
whose sub-models share one structure and leaf shapes stack along a
leading member axis, and the grouped round engine
(``core/round_engine.GroupedRoundEngine``) serves each group in one pass.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch import tree
from repro_torch.core.allocation import ClientTelemetry


def sample_system_telemetry(
    num_clients: int,
    model_bytes: Sequence[float],
    num_samples: Sequence[int],
    label_coverage: Sequence[float],
    *,
    local_epochs: int = 1,
    seed: int = 0,
    initial_loss: float = 1.0,
) -> ClientTelemetry:
    rng = np.random.default_rng(seed)
    n = num_clients
    bits_u = rng.uniform(1e4, 5e4, n)            # bit/s (Table 4)
    bits_d = rng.uniform(4e4, 2e5, n)
    f_ghz = rng.uniform(1, 10, n)                # GHz
    c_mc = rng.uniform(1, 10, n)                 # Megacycles/sample
    samples = np.asarray(num_samples, float)
    t_cmp = c_mc * 1e6 * samples * local_epochs / (f_ghz * 1e9)
    return ClientTelemetry(
        model_bytes=np.asarray(model_bytes, float),
        uplink_rate=bits_u / 8.0,                # bytes/s
        downlink_rate=bits_d / 8.0,
        compute_latency=t_cmp,
        num_samples=samples,
        label_coverage=np.asarray(label_coverage, float),
        train_loss=np.full(n, initial_loss),
    )


# --------------------------------------------------------------- shape groups

@dataclasses.dataclass(frozen=True)
class ShapeGroup:
    """One class of a ragged fleet: every member holds a sub-model with the
    same pytree structure, leaf shapes and dtypes, so their parameters
    stack along a leading member axis.

    ``indices`` are the members' fleet positions (ascending): the rows
    they occupy in the full-fleet aggregation canvas and the ids their
    mask and quantization keys fold in, so grouped rounds equal the
    per-client loop's.
    """

    signature: Tuple                 # (treedef, ((shape, dtype name), ...))
    indices: Tuple[int, ...]         # fleet positions of the members

    @property
    def size(self) -> int:
        return len(self.indices)


def _dtype_name(leaf) -> str:
    """``float32``, ``bfloat16``, ...: the JAX package's dtype strings."""
    return str(leaf.dtype).rpartition(".")[2]


def shape_signature(params) -> Tuple:
    """Hashable identity of a pytree's structure, leaf shapes and dtypes
    (``tree.flatten``'s treedef is nested tuples: equal structures give
    equal, hashable treedefs)."""
    leaves, treedef = tree.flatten(params)
    return (treedef, tuple((tuple(l.shape), _dtype_name(l))
                           for l in leaves))


def group_by_shape(client_params: Sequence) -> List[ShapeGroup]:
    """Partition a fleet by sub-model shape, the groups ordered by their
    smallest member (a function of the fleet alone); a homogeneous fleet
    is one group."""
    members: dict = {}
    for i, p in enumerate(client_params):
        members.setdefault(shape_signature(p), []).append(i)
    groups = [ShapeGroup(signature=sig, indices=tuple(idx))
              for sig, idx in members.items()]
    return sorted(groups, key=lambda g: g.indices[0])
