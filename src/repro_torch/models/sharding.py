"""Logical-axis sharding rules, and the placement of trees on a mesh:
the counterpart of ``repro.models.sharding``.

Every parameter and state leaf carries *logical* axis names; a rules
table maps them to the axes of a mesh (``launch.mesh.LMMesh`` or the
named ``ProductionMesh``: ``("data", "model")`` per pod with an optional
leading ``"pod"``).  A spec is a tuple with one entry per dimension
(``None``, a mesh-axis name, or a tuple of names, the first the major
one), and :func:`local_shape` the block of a leaf one device holds under
it.

The JAX package hands its ``PartitionSpec`` s to XLA's SPMD partitioner
through ``shard()`` and ``named_sharding``.  The port has no
partitioner; its twin of them is explicit placement on an ``LMMesh``:
:func:`place` cuts every leaf into the blocks its spec gives each device
and copies each block to its device (a :class:`Placed` tree),
:func:`gather` puts the blocks back together, :func:`local_tree` gathers
a layer's blocks over the non-``model`` axes just before use (the
all-gather GSPMD inserts for FSDP-sharded fan-in), and
:func:`psum_model` sums a row's partial results over ``model`` in a fixed
order on the row's first device (the all-reduce after a row-parallel
matmul).  The model's meshed paths (``models.lm`` with ``mesh=``) run
every device's share from one process with these.

Autograd differentiates through them: the transpose of ``psum_model``
hands each row's cotangent to every partial, and ``local_tree``'s copies
(``CopySlices``) send each gathered slice's gradient to the block it was
read from.  A block several devices hold (replicated over the axes its
spec leaves out) gets only the gradient of the uses that read that
copy; :func:`reduce_replicas` sums them, and :func:`global_sq_norm`
counts each distinct block once.

Default rules (MaxText-style FSDP + TP), the reference's:

  batch     -> ("pod", "data")     activations' batch dim
  embed     -> ("pod", "data")     parameter fan-in  (FSDP)
  heads     -> "model"             attention heads   (TP)
  mlp       -> "model"             FFN hidden        (TP)
  vocab     -> "model"             embedding/logits vocab dim
  experts   -> "model"             MoE expert-parallel
  kv_heads  -> "model"
  seq, layers, conv, state, ...    -> replicated

"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import tree as tree_mod

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


def n_shards(logical: Optional[str], mesh) -> int:
    """The product of the sizes of the mesh axes the rules map ``logical``
    to (whether or not they divide a dimension)."""
    sizes = _axis_sizes(mesh)
    n = 1
    for a in _axes(_rules.get(logical)):
        n *= sizes.get(a, 1)
    return n


def block_count(entry: Entry, mesh) -> int:
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
        n = block_count(e, mesh)
        if d % n:
            raise ValueError(f"dim {d} does not split into {n} blocks "
                             f"({e})")
        out.append(d // n)
    return tuple(out)


# ------------------------------------------------------------ placement ----

def _axes(entry: Entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _position(entry: Entry, coords: Dict[str, int], sizes: Dict[str, int],
              over: Sequence[str]) -> Tuple[int, int]:
    """(block index, block count) of a dimension under ``entry`` at
    ``coords``, counting only the mesh axes in ``over`` (the first axis of
    the entry is the major one, as in a ``PartitionSpec``)."""
    pos, n = 0, 1
    for a in _axes(entry):
        if a in over:
            pos = pos * sizes[a] + coords[a]
            n *= sizes[a]
    return pos, n


def block_range(entry: Entry, mesh, k: int, n: int) -> Tuple[int, int]:
    """The slice [lo, hi) of a dimension of ``n`` device ``k`` holds under
    ``entry``."""
    pos, c = _position(entry, mesh.coords(k), _axis_sizes(mesh),
                       mesh.axis_names)
    if n % c:
        raise ValueError(f"dim {n} does not split into {c} blocks ({entry})")
    return pos * (n // c), (pos + 1) * (n // c)


def block(t: torch.Tensor, spec_: Spec, mesh, k: int) -> torch.Tensor:
    """Device ``k``'s block of ``t`` under ``spec_`` (a view)."""
    if len(spec_) != t.dim():
        raise ValueError(f"spec {spec_} for a rank-{t.dim()} leaf")
    sizes, coords = _axis_sizes(mesh), mesh.coords(k)
    idx = []
    for d, e in zip(t.shape, spec_):
        pos, n = _position(e, coords, sizes, mesh.axis_names)
        if d % n:
            raise ValueError(f"dim {d} does not split into {n} blocks ({e})")
        idx.append(slice(pos * (d // n), (pos + 1) * (d // n)))
    return t[tuple(idx)]


def split(t: torch.Tensor, spec_: Spec, mesh) -> List[torch.Tensor]:
    """Each device's block of an activation, on its device (a view where
    the block already lies there: inputs are read, never written)."""
    return [block(t, spec_, mesh, k).to(mesh.devices[k])
            for k in range(mesh.size)]


def assemble(blocks: Sequence, spec_: Spec, mesh, ks: Sequence[int],
             over: Sequence[str], device) -> torch.Tensor:
    """The tensor the blocks of devices ``ks`` make along the mesh axes
    ``over`` (other axes stay cut), on ``device``.  Devices holding the
    same block (replicated) are read once; a single block needing no
    assembly is returned as it is when it lies on ``device``."""
    sizes = _axis_sizes(mesh)
    first = blocks[ks[0]]
    counts = [_position(e, mesh.coords(ks[0]), sizes, over)[1]
              for e in spec_]
    if all(n == 1 for n in counts):
        return first.to(device)
    out = torch.empty([d * n for d, n in zip(first.shape, counts)],
                      dtype=first.dtype, device=device)
    seen = set()
    for k in ks:
        coords = mesh.coords(k)
        pos = tuple(_position(e, coords, sizes, over)[0] for e in spec_)
        if pos in seen:
            continue
        seen.add(pos)
        blk = blocks[k]
        out[tuple(slice(p * d, (p + 1) * d)
                  for p, d in zip(pos, blk.shape))].copy_(blk)
    return out


def unsplit(blocks: Sequence[torch.Tensor], spec_: Spec, mesh,
            device=None) -> torch.Tensor:
    """The inverse of :func:`split`: the whole tensor on ``device`` (the
    mesh's first device by default)."""
    return assemble(blocks, spec_, mesh, range(mesh.size), mesh.axis_names,
                    mesh.devices[0] if device is None else device)


def _paired(tree, specs) -> List[Tuple[Any, Spec]]:
    """``(leaf, spec)`` pairs of ``tree`` and its spec tree, in
    ``tree.named_leaves`` order; the two trees must name the same
    leaves."""
    a, b = list(tree_mod.named_leaves(tree)), list(
        tree_mod.named_leaves(specs))
    if [n for n, _ in a] != [n for n, _ in b]:
        raise ValueError("specs do not match the tree")
    return [(t, sp) for (_, t), (_, sp) in zip(a, b)]


@dataclasses.dataclass(frozen=True)
class Placed:
    """A tree placed on an ``LMMesh``: ``shards[k]`` is the tree of blocks
    device ``k`` holds, each leaf's block cut by its entry in ``specs``
    (a tree of the same structure, walked as ``tree.named_leaves``
    walks: dicts, lists and named tuples)."""

    mesh: Any
    specs: Any
    shards: Tuple[Any, ...]


def place(tree, specs, mesh) -> Placed:
    """Cut every tensor leaf of ``tree`` into the block ``specs`` gives
    each device of ``mesh`` and copy it there: every device holds fresh
    storage for its blocks, as a real mesh does, also where devices
    repeat.  Host scalars are handed to every device as they are."""
    pairs = _paired(tree, specs)
    shards = []
    for k, dev in enumerate(mesh.devices):
        out = []
        for t, sp in pairs:
            if isinstance(t, torch.Tensor):
                blk = block(t, sp, mesh, k)
                t = torch.empty(blk.shape, dtype=blk.dtype,
                                device=dev).copy_(blk)
            out.append(t)
        shards.append(tree_mod.unflatten_named(tree, out))
    return Placed(mesh, specs, tuple(shards))


def gather(placed: Placed, device=None):
    """The inverse of :func:`place`: the whole tree on ``device`` (the
    mesh's first device by default), bit for bit."""
    mesh = placed.mesh
    dev = mesh.devices[0] if device is None else device
    per_dev = [_paired(s, placed.specs) for s in placed.shards]
    out = []
    for i, (_, sp) in enumerate(per_dev[0]):
        blocks = [ps[i][0] for ps in per_dev]
        out.append(unsplit(blocks, sp, mesh, dev)
                   if isinstance(blocks[0], torch.Tensor) else blocks[0])
    return tree_mod.unflatten_named(placed.shards[0], out)


def local_tree(shards: Sequence, specs, mesh, k: int):
    """What device ``k`` computes with: each leaf of its subtree
    ``shards[k]`` gathered over the non-``model`` axes from the devices
    of its model column (FSDP fan-in all-gathered just before use), so
    only the ``model``-sharded dims stay cut.  A leaf cut by no other axis
    is device ``k``'s own block, not a copy."""
    over = tuple(a for a in mesh.axis_names if a != "model")
    col = [i for i in range(mesh.size) if mesh.col(i) == mesh.col(k)]
    col = [k] + [i for i in col if i != k]     # read its own block first
    per_dev = {i: _paired(shards[i], specs) for i in col}
    out = []
    for n, (_, sp) in enumerate(per_dev[k]):
        blocks = {i: per_dev[i][n][0] for i in col}
        out.append(assemble(blocks, sp, mesh, col, over, mesh.devices[k])
                   if isinstance(blocks[k], torch.Tensor) else blocks[k])
    return tree_mod.unflatten_named(shards[k], out)


def read(blocks: Sequence, spec_: Spec, mesh, k: int,
         region: Sequence) -> torch.Tensor:
    """Device ``k``'s copy of a region of a leaf cut into ``blocks`` by
    ``spec_``: ``region`` gives, for each dimension, a list of ``[lo,
    hi)`` ranges of the whole leaf (``None``: all of it), laid side by
    side in that order.  Each piece comes from device ``k``'s own block
    where it holds it, else from the first device holding it (the
    devices of its row across ``model``, of its column across the data
    axes); only the ranges asked for are copied.  Autograd's transpose of
    the copies (``CopySlices``) lands on the block each piece was read
    from.  A region equal to device ``k``'s block is that block itself.

    The reads a device needs where its computation does not follow a
    leaf's cut: the ``x`` and ``z`` halves of a fused ``(d, 2 di)``
    projection cut over ``model`` as one dimension, or whole heads of a
    leaf cut within them."""
    sizes = _axis_sizes(mesh)
    own = blocks[k]
    dev = mesh.devices[k]
    whole = [d * block_count(e, mesh) for d, e in zip(own.shape, spec_)]
    ranges = [[(0, n)] if r is None else [tuple(x) for x in r]
              for r, n in zip(region, whole)]
    mine = [block_range(e, mesh, k, n) for e, n in zip(spec_, whole)]
    if all(r == [m] for r, m in zip(ranges, mine)):
        return own.to(dev)
    out = torch.empty([sum(hi - lo for lo, hi in r) for r in ranges],
                      dtype=own.dtype, device=dev)
    seen = set()
    for i in [k] + [i for i in range(mesh.size) if i != k]:
        coords = mesh.coords(i)
        pos = tuple(_position(e, coords, sizes, mesh.axis_names)[0]
                    for e in spec_)
        if pos in seen:
            continue
        seen.add(pos)
        blk = blocks[i]
        per_dim = []
        for p, d, rs in zip(pos, blk.shape, ranges):
            b_lo, b_hi, off, pieces = p * d, (p + 1) * d, 0, []
            for lo, hi in rs:
                a, b = max(lo, b_lo), min(hi, b_hi)
                if a < b:
                    pieces.append((slice(off + a - lo, off + b - lo),
                                   slice(a - b_lo, b - b_lo)))
                off += hi - lo
            per_dim.append(pieces)
        for combo in itertools.product(*per_dim):
            out[tuple(o for o, _ in combo)].copy_(
                blk[tuple(s for _, s in combo)])
    return out


def psum_model(parts: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """All-reduce over ``model``: each row's partials summed in model order
    on the row's first device (so two runs are bit-equal), the sum handed
    to every device of the row (the same tensor on a virtual mesh)."""
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    m = mesh.n_model
    for r in range(mesh.n_rows):
        ks = range(r * m, (r + 1) * m)
        dev0 = mesh.devices[ks[0]]
        total = parts[ks[0]]
        for k in ks[1:]:
            total = total + parts[k].to(dev0)
        for k in ks:
            out[k] = total.to(mesh.devices[k])
    return out


# ------------------------------------------------------------ gradients ----

def holders(spec_: Spec, mesh) -> List[List[int]]:
    """The devices holding each distinct block of a leaf under ``spec_``:
    one group a block, each in device order, the groups in the order of
    their first device.  The devices of a group differ only along the mesh
    axes ``spec_`` does not use (``pod`` included): they hold replicas."""
    used = {a for e in spec_ for a in _axes(e)}
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for k in range(mesh.size):
        c = mesh.coords(k)
        groups.setdefault(tuple(c[a] for a in mesh.axis_names if a in used),
                          []).append(k)
    return list(groups.values())


def reduce_replicas(grads: Placed) -> Placed:
    """Every block's gradient summed over the devices that hold the same
    block: autograd gives each replica the gradient of the uses that read
    it (:func:`local_tree` reads a block position once, from the first
    holder of its column), so the whole gradient is their sum.  Summed in
    device order on the first holder and handed back to every holder
    (the same tensor where they share a device), so two runs are
    bit-equal.  A leaf cut over every mesh axis is left as it is."""
    mesh = grads.mesh
    per_dev = [tree_mod.named_values(s) for s in grads.shards]
    out = [list(v) for v in per_dev]
    for i, sp in enumerate(tree_mod.named_values(grads.specs)):
        if not isinstance(per_dev[0][i], torch.Tensor):
            continue
        for ks in holders(sp, mesh):
            if len(ks) == 1:
                continue
            dev0 = mesh.devices[ks[0]]
            total = per_dev[ks[0]][i]
            for k in ks[1:]:
                total = total + per_dev[k][i].to(dev0)
            for k in ks:
                out[k][i] = total.to(mesh.devices[k])
    return Placed(mesh, grads.specs, tuple(
        tree_mod.unflatten_named(s, o) for s, o in zip(grads.shards, out)))


def global_sq_norm(placed: Placed) -> torch.Tensor:
    """The sum of squares (fp32) of the whole tree a placement holds:
    each distinct block counted once (its first holder's), leaf by leaf
    and block by block in device order, summed on the mesh's first
    device."""
    mesh = placed.mesh
    dev0 = mesh.devices[0]
    per_dev = [tree_mod.named_values(s) for s in placed.shards]
    total = torch.zeros((), dtype=torch.float32, device=dev0)
    for i, sp in enumerate(tree_mod.named_values(placed.specs)):
        for ks in holders(sp, mesh):
            t = per_dev[ks[0]][i]
            total = total + torch.sum(torch.square(t.float())).to(dev0)
    return total


def sum_blocks(parts: Sequence[torch.Tensor], spec_: Spec, summed: Entry,
               mesh, device) -> torch.Tensor:
    """The whole tensor the devices' partial blocks ``parts`` make: each
    cut by ``spec_`` and a partial sum over the mesh axes of the entry
    ``summed`` (those that cut a dimension a reduction removed).  Each
    distinct (block, partial) is added once, in device order, on
    ``device``."""
    sizes = _axis_sizes(mesh)
    shape = [d * block_count(e, mesh) for d, e in zip(parts[0].shape, spec_)]
    out = torch.zeros(shape, dtype=parts[0].dtype, device=device)
    seen = set()
    for k, part in enumerate(parts):
        coords = mesh.coords(k)
        pos = tuple(_position(e, coords, sizes, mesh.axis_names)[0]
                    for e in spec_)
        key = pos + tuple(coords[a] for a in _axes(summed))
        if key in seen:
            continue
        seen.add(key)
        out[tuple(slice(p * d, (p + 1) * d)
                  for p, d in zip(pos, part.shape))] += part.to(device)
    return out


def zeros(shapes, specs, mesh, fill: Optional[Sequence[float]] = None
          ) -> Placed:
    """Every device's blocks of the abstract tree ``shapes`` (meta
    tensors) under ``specs``, each allocated on its device: zeros, or
    ``fill``'s value of each leaf (in ``tree.named_leaves`` order)."""
    pairs = _paired(shapes, specs)
    fill = [0.0] * len(pairs) if fill is None else list(fill)
    return Placed(mesh, specs, tuple(tree_mod.unflatten_named(shapes, [
        torch.full(local_shape(t.shape, sp, mesh), v, dtype=t.dtype,
                   device=dev) for (t, sp), v in zip(pairs, fill)])
        for dev in mesh.devices))


def device_bytes(placed: Placed) -> List[int]:
    """The bytes of tensor blocks each device holds."""
    return [sum(t.numel() * t.element_size()
                for t in tree_mod.named_values(s)
                if isinstance(t, torch.Tensor)) for s in placed.shards]


def local_bytes(tree, specs, mesh) -> int:
    """One device's bytes of ``tree`` by :func:`local_shape` (the same on
    every device of a mesh)."""
    total = 0
    for t, sp in _paired(tree, specs):
        if isinstance(t, torch.Tensor):
            n = 1
            for d in local_shape(t.shape, sp, mesh):
                n *= d
            total += n * t.element_size()
    return total
