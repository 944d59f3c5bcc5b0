"""Checkpointing: flattened-pytree .npz tensors + a msgpack/JSON sidecar.

Tensors are copied to the host before writing.  Structure round-trips
exactly: each leaf's npz key is its tree path as
``repro_torch.tree.keystr`` renders it, which is the string
``jax.tree_util.keystr`` gives the same path, so a file the JAX package
wrote loads here and the other way round.

Writes are ATOMIC (write-temp + fsync + rename): a process killed
mid-write — the crash-mid-round scenario the fault layer
(repro_torch.sim.faults) injects on the simulated side — leaves either
the previous checkpoint intact or the new one complete, never a torn
file.

The sidecar is msgpack when the ``msgpack`` package imports and JSON
otherwise, as the JAX package writes it.  Reading takes either: JSON
when the bytes parse as JSON, else msgpack (which then must import).
"""

from __future__ import annotations

import io
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree

try:
    import msgpack
    _HAVE_MSGPACK = True
except ImportError:                               # pragma: no cover
    msgpack = None
    _HAVE_MSGPACK = False


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            # bfloat16 has no numpy dtype: store float32 (exact); the
            # load casts back to the template's dtype
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree_) -> Dict[str, np.ndarray]:
    pairs, _ = tree.flatten_with_path(tree_)
    return {tree.keystr(path): _host(leaf) for path, leaf in pairs}


def _atomic_write_bytes(path: Path, data: bytes) -> None:
    """Durably replace ``path``: temp file + fsync + atomic rename.

    ``os.replace`` is atomic on POSIX, so a reader (or a crash) can only
    ever observe the old complete file or the new complete file.
    """
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def encode_meta(meta: Dict) -> bytes:
    """The sidecar's bytes: msgpack when it imports, else JSON."""
    return (msgpack.packb(meta) if _HAVE_MSGPACK
            else json.dumps(meta).encode())


def decode_meta(raw: bytes) -> Dict:
    """A sidecar in either format: JSON when the bytes parse as JSON,
    else msgpack."""
    try:
        return json.loads(raw.decode())
    except (UnicodeDecodeError, ValueError):
        pass
    if not _HAVE_MSGPACK:
        raise ValueError(
            "checkpoint sidecar is not JSON and the msgpack package is not "
            "installed to read it (the JAX package writes msgpack when it "
            "can import it)")
    return msgpack.unpackb(raw)


def save_checkpoint(path: str | Path, tree_: Any,
                    metadata: Optional[Dict] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree_)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    _atomic_write_bytes(path, buf.getvalue())
    meta = dict(metadata or {})
    meta["_keys"] = sorted(flat.keys())
    _atomic_write_bytes(Path(str(path) + ".meta"), encode_meta(meta))


def load_checkpoint(path: str | Path, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (shape/dtype template): a
    numpy leaf of the template comes back as numpy at its dtype (float64
    host state stays float64), a tensor leaf as a tensor of its dtype on
    its device."""
    path = Path(path)
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    meta_path = Path(str(path) + ".meta")
    meta: Dict = {}
    if meta_path.exists():
        meta = decode_meta(meta_path.read_bytes())
    pairs, treedef = tree.flatten_with_path(like)
    leaves = []
    for p, leaf in pairs:
        key = tree.keystr(p)
        if key not in data:
            raise KeyError(f"checkpoint missing {key}")
        arr = data[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            leaves.append(torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=leaf.device, dtype=leaf.dtype))
        else:
            leaves.append(np.asarray(arr, dtype=np.asarray(leaf).dtype))
    return tree.unflatten(treedef, leaves), meta
