"""Logical-axis sharding rules, as shapes: the counterpart of
``repro.models.sharding`` without a partitioner.

Every parameter and state leaf carries *logical* axis names; a rules
table maps them to the axes of a mesh (``launch.mesh.ProductionMesh``,
``("data", "model")`` per pod with an optional leading ``"pod"``).  The
JAX package hands the resulting ``PartitionSpec`` s to XLA's SPMD
partitioner.  The port runs on one card and has no partitioner, so a
spec here is only what the per-device accounting needs: a tuple with one
entry per dimension (``None``, a mesh-axis name, or a tuple of names),
and :func:`local_shape`, the block of a leaf one device holds under it.

Default rules (MaxText-style FSDP + TP), the reference's:

  batch     -> ("pod", "data")     activations' batch dim
  embed     -> ("pod", "data")     parameter fan-in  (FSDP)
  heads     -> "model"             attention heads   (TP)
  mlp       -> "model"             FFN hidden        (TP)
  vocab     -> "model"             embedding/logits vocab dim
  experts   -> "model"             MoE expert-parallel
  kv_heads  -> "model"
  seq, layers, conv, state, ...    -> replicated

The reference's ``shard()`` and ``named_sharding`` have no twin: on one
card they are the identity, and no torch op consumes a spec.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# logical name -> mesh axes (None = replicate); a tuple shards over the
# product of its mesh axes.  Mutated only through set_rules().
_DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "embed": ("pod", "data"),
    "table_embed": ("pod", "data"),
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "seq": None,
    "seq_act": None,
    "residual": None,
    "kv_seq": None,
    "layers": None,
    "conv": None,
    "state": None,
    "capacity": None,
    "dconv": None,
    "inner": "model",          # mamba/xlstm inner (expanded) dim
    "head_out": None,
    None: None,
}

_rules = dict(_DEFAULT_RULES)


def set_rules(**overrides) -> None:
    """Override logical -> mesh mappings (the dry-run's ``--rules`` and
    the run policies)."""
    _rules.update(overrides)


def reset_rules() -> None:
    _rules.clear()
    _rules.update(_DEFAULT_RULES)


def _axis_sizes(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def _resolve(ax: Optional[str], dim: Optional[int],
             axis_sizes: Dict[str, int]) -> Entry:
    """Map one logical axis to mesh axes, honouring divisibility of ``dim``.

    Mesh axes missing from the mesh are dropped; if ``dim`` is given, axes
    whose (product) size does not divide it are dropped greedily."""
    m = _rules.get(ax, None)
    if m is None:
        return None
    cand = m if isinstance(m, tuple) else (m,)
    kept = []
    prod = 1
    for a in cand:
        sz = axis_sizes.get(a)
        if sz is None:
            continue
        if dim is not None and dim % (prod * sz) != 0:
            continue
        kept.append(a)
        prod *= sz
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def spec(*logical_axes: Optional[str],
         shape: Optional[Sequence[int]] = None, mesh=None) -> Spec:
    """The spec of the given logical axes on ``mesh`` (None: no mesh, all
    replicated), dropping absent mesh axes and non-divisible dims; a mesh
    axis appears at most once (the first use wins)."""
    sizes = _axis_sizes(mesh)
    out = []
    used = set()
    for i, ax in enumerate(logical_axes):
        dim = shape[i] if shape is not None else None
        r = _resolve(ax, dim, sizes)
        if isinstance(r, tuple):
            r = tuple(a for a in r if a not in used)
            r = r if len(r) > 1 else (r[0] if r else None)
        if isinstance(r, str) and r in used:
            r = None
        for a in ((r,) if isinstance(r, str) else (r or ())):
            used.add(a)
        out.append(r)
    return tuple(out)


def _shards(entry: Entry, mesh) -> int:
    """How many blocks one spec entry cuts its dimension into."""
    sizes = _axis_sizes(mesh)
    n = 1
    for a in ((entry,) if isinstance(entry, str) else (entry or ())):
        n *= sizes[a]
    return n


def local_shape(shape: Sequence[int], spec_: Spec, mesh
                ) -> Tuple[int, ...]:
    """The block of a ``shape`` leaf one device holds under ``spec_``: the
    in-spec of a ``shard_map``, each dimension divided by the product of
    its mesh axes (which must divide it)."""
    if len(spec_) != len(shape):
        raise ValueError(f"spec {spec_} for a rank-{len(shape)} leaf")
    out = []
    for d, e in zip(shape, spec_):
        n = _shards(e, mesh)
        if d % n:
            raise ValueError(f"dim {d} does not split into {n} blocks "
                             f"({e})")
        out.append(d // n)
    return tuple(out)
