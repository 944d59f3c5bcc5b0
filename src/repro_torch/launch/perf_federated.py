"""FedDD's cross-pod parameter sync on the production mesh: the bytes one
synchronisation of a whole parameter set moves, and its time on virtual
pods of one card.

    PYTHONPATH=src python -m repro_torch.launch.perf_federated \
        [--arch granite_3_8b] [--rates 0.0 0.4 0.6 0.8] [--device cpu] \
        [--results-dir DIR]

The counterpart of ``repro.launch.perf_federated``.  Within a pod every
leaf is sharded as the trainer shards it (``lm.param_pspecs`` on the
``(pod=2, data=16, model=16)`` mesh), and each (data, model) cell
exchanges only its local shard with its cross-pod peer:

  dense     FedAvg: every leaf's weighted mean over ``pod`` (an
            all-reduce of the fp32 value and one of the weight);
  feddd(D)  the paper's technique: a 1-D leaf takes the dense mean; a
            rank-2+ leaf ranks its last-axis channels by Eq. (20)
            importance (the kernel), keeps ``k = max(1, ceil(C (1 - D)))``
            (``compact_topk``), all-gathers the compacted values and their
            indices, scatter-adds them (``scatter_accumulate``) and takes
            the mean, keeping the local value where no pod sent the
            channel; one sync at each of ``--rates``;
  int8      feddd whose compacted values travel as int8 with a
            per-channel fp32 absmax scale.

The JAX package compiles this for 512 chips and reads the collectives'
operand bytes from the partitioned HLO.  Here one process drives the two
pods of one cell as virtual pods of a ``ClientMesh`` (as
``launch.federated`` does) and counts each collective's operand bytes
per device and per kind, as that HLO parser counts them (an all-gather
counts its operand, not the gathered result).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.importance import channel_importance
from repro_torch.core.sparse_collective import (compact_topk,
                                                dense_allreduce_mean,
                                                on_device, replicate,
                                                scatter_accumulate)
from repro_torch.device import resolve_device
from repro_torch.launch.dryrun import RESULTS_DIR
from repro_torch.launch.federated import pod_mesh
from repro_torch.launch.hlo_analysis import Hardware
from repro_torch.launch.mesh import ClientMesh, make_production_mesh
from repro_torch.models import lm, sharding

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_EPS = 1e-12
# the reference's jitted int8 quantiser multiplies by float32(1/127) for
# its "/ 127.0" (XLA rewrites a division by a constant so)
_INV127 = 1.0 / 127.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def keep_count(c: int, d_rate: float) -> int:
    return max(1, int(math.ceil(c * (1.0 - d_rate))))


def _sync_dense(news: Sequence[torch.Tensor], mesh: ClientMesh,
                counts: Dict[str, int]) -> List[torch.Tensor]:
    """The weighted dense mean: a psum of the fp32 value (and of the pod's
    weight, counted once a sync by :func:`build_sync`)."""
    counts["all-reduce"] += news[0].numel() * 4
    return dense_allreduce_mean(news, mesh)


def _quantize(compact: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values (k, F), fp32 per-channel absmax scales (k, 1))."""
    flat = compact.reshape(compact.shape[0], -1).float()
    amax = flat.abs().amax(dim=1, keepdim=True)
    scale = amax * torch.tensor(_INV127, dtype=torch.float32,
                                device=flat.device)
    q = torch.clamp(torch.round(flat / torch.clamp(scale, min=_EPS)),
                    -127, 127).to(torch.int8)
    return q, scale


def _sync_sparse(olds: Sequence[torch.Tensor], news: Sequence[torch.Tensor],
                 mesh: ClientMesh, d_rate: float, quant: str,
                 counts: Dict[str, int]) -> List[torch.Tensor]:
    """FedDD's compacted exchange of one leaf's local shards over the
    pods (channels: the last axis)."""
    if news[0].ndim <= 1:
        return _sync_dense(news, mesh, counts)
    dev0 = mesh.devices[0]
    c = news[0].shape[-1]
    k = keep_count(c, d_rate)
    rows, idxs = [], []
    for old, new in zip(olds, news):
        # Eq. (20) over the last-axis channels, the leaf read in place
        scores = channel_importance(old, new, channel_axis=-1)
        compact, idx = compact_topk(new.movedim(-1, 0), scores, k)
        sent = (compact, idx)
        if quant == "int8":
            q, scale = _quantize(compact)
            sent = (q, scale, idx)
            compact = (q.float() * scale).reshape(compact.shape)
        if not rows:       # per device: one pod's operands
            counts["all-gather"] += sum(_nbytes(t) for t in sent)
        rows.append(on_device(compact, dev0))
        idxs.append(on_device(idx, dev0))
    shape = (c,) + tuple(news[0].shape[:-1])
    num, cnt = scatter_accumulate(shape, torch.cat(rows), torch.cat(idxs))
    wshape = (c,) + (1,) * (len(shape) - 1)
    agg = num / torch.clamp(cnt, min=_EPS).reshape(wshape)
    keep_local = (cnt <= _EPS).reshape(wshape)
    out = []
    for new, a, kl in zip(news, replicate(agg, mesh),
                          replicate(keep_local, mesh)):
        nm = new.movedim(-1, 0)
        out.append(torch.where(kl, nm, a.to(nm.dtype)).movedim(0, -1)
                   .contiguous())
    return out


def build_sync(cfg, mesh_shape, mode: str, d_rate: float = 0.0,
               quant: str = "none"):
    """(sync, local_shapes): ``sync(olds, news, pods)`` exchanges one
    cell's local shards across ``pods`` (a ``ClientMesh`` of the mesh's
    ``pod`` size) and returns (per-pod synced trees, collective operand
    bytes per device by kind); ``olds``/``news`` are per-pod trees of
    ``local_shapes``, each leaf's block under ``lm.param_pspecs`` on
    ``mesh_shape`` (a ``ProductionMesh`` with a ``pod`` axis)."""
    if mode not in ("dense", "feddd"):
        raise ValueError(f"mode must be dense or feddd, got {mode!r}")
    if quant not in ("none", "int8"):
        raise ValueError(f"quant must be none or int8, got {quant!r}")
    p_shape = lm.abstract_params(cfg)
    # a spec is a tuple, a leaf of ``tree``: tree_map pairs each parameter
    # with its own spec and raises if the structures differ
    local = tree.tree_map(
        lambda t, s: sharding.local_shape(tuple(t.shape), s, mesh_shape),
        p_shape, lm.param_pspecs(cfg, p_shape, mesh_shape))

    def sync(olds, news, pods: ClientMesh):
        counts = {k: 0 for k in COLLECTIVES}
        old_l = [tree.leaves(o) for o in olds]
        new_l, td = [], None
        for n in news:
            leaves, td = tree.flatten(n)
            new_l.append(leaves)
        out = [[] for _ in news]
        for li in range(len(new_l[0])):
            o_li = [ol[li] for ol in old_l]
            n_li = [nl[li] for nl in new_l]
            if n_li[0].ndim == 0 and mode == "dense":
                agg = n_li
            elif mode == "dense":
                agg = _sync_dense(n_li, pods, counts)
            else:
                agg = _sync_sparse(o_li, n_li, pods, d_rate, quant, counts)
            for o, a in zip(out, agg):
                o.append(a)
        if counts["all-reduce"]:
            # every dense mean divides by the psum of one weight, 1.0 a
            # pod: one fp32 all-reduce a sync (XLA's CSE merges the
            # reference's per-leaf psums of it into one)
            counts["all-reduce"] += 4
        return [tree.unflatten(td, o) for o in out], counts

    return sync, local


def random_cell(cfg, local_shapes, pods: ClientMesh, seed: int = 0):
    """Per-pod (olds, news) of one cell: old ~ 0.02 N(0, 1) in the
    parameters' dtypes, new = old + 1e-3 N(0, 1) per pod, on each pod's
    device."""
    p_shape = lm.abstract_params(cfg)
    olds, news = [], []
    for p, dev in enumerate(pods.devices):
        gen = torch.Generator(device=dev).manual_seed(seed * 1000 + p)

        def draw(ref, shape):
            return (torch.randn(shape, generator=gen, device=dev)
                    * 0.02).to(ref.dtype)

        old = tree.tree_map(draw, p_shape, local_shapes)
        new = tree.tree_map(
            lambda t: (t.float() + 1e-3 * torch.randn(
                t.shape, generator=gen, device=dev)).to(t.dtype), old)
        olds.append(old)
        news.append(new)
    return olds, news


RATES = (0.0, 0.4, 0.6, 0.8)         # ``--rates``' default
INT8_RATES = (0.6, 0.8)


def modes(rates: Sequence[float] = RATES) -> List[Tuple[str, float, str]]:
    """The syncs one run measures, in the reference's order: dense, feddd
    at each of ``rates``, then int8 feddd at 0.6 and 0.8."""
    return ([("dense", 0.0, "none")]
            + [("feddd", float(d), "none") for d in rates]
            + [("feddd", d, "int8") for d in INT8_RATES])


MODES = modes()


def mode_tag(mode: str, d_rate: float, quant: str) -> str:
    tag = f"fed_{mode}" + (f"_d{int(round(d_rate * 100))}"
                           if mode == "feddd" else "")
    return tag + (f"_{quant}" if quant != "none" else "")


def run_one(cfg, mesh_shape, pods: ClientMesh, mode: str, d_rate: float,
            quant: str, cell) -> Dict:
    """One sync of ``cell``, the (olds, news) of :func:`random_cell`: its
    record (bytes per device by kind, the collective term on
    ``Hardware.link_bw``, the synchronised wall ms and the importance
    launches) and the synced trees."""
    from repro_torch import kernels
    sync, _ = build_sync(cfg, mesh_shape, mode, d_rate, quant)
    olds, news = cell
    dev = pods.devices[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out, coll = sync(olds, news, pods)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    total = sum(coll.values())
    return {
        "arch": cfg.name, "shape": "train_4k", "mesh": "multi",
        "mesh_shape": list(mesh_shape.axis_sizes),
        "tag": mode_tag(mode, d_rate, quant), "status": "ok", "mode": mode,
        "d_rate": d_rate, "quant": quant,
        "collective_per_device": coll,
        "collective_bytes_per_device": total,
        "collective_term_s": total / Hardware().link_bw,
        "wall_ms": wall * 1e3, "device": str(dev),
        "importance_launches": kernels.launch_counts()["importance"],
    }, out


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite_3_8b", choices=ARCH_IDS)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--results-dir", default=str(RESULTS_DIR))
    ap.add_argument("--rates", nargs="*", type=float, default=list(RATES),
                    help="the feddd syncs' dropout rates")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    mesh_shape = make_production_mesh(multi_pod=True)
    pods = pod_mesh(mesh_shape.shape["pod"], dev)
    _, local = build_sync(cfg, mesh_shape, "dense")
    cell = random_cell(cfg, local, pods)
    out = []
    for mode, d, quant in modes(args.rates):
        rec, _ = run_one(cfg, mesh_shape, pods, mode, d, quant, cell)
        out.append(rec)
        print(f"{rec['tag']:>16}: "
              f"{rec['collective_bytes_per_device'] / 1e6:9.3f} MB/dev  "
              f"term={rec['collective_term_s'] * 1e3:.4f} ms  "
              f"wall={rec['wall_ms']:.2f} ms  importance "
              f"{rec['importance_launches']}", flush=True)
    path = Path(args.results_dir) / f"federated_sync_{cfg.name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print("written", path)
    return out


if __name__ == "__main__":
    main()
