"""Federated-pods driver: FedDD across pods, each pod a client training a
replica of a transformer.

    PYTHONPATH=src python -m repro_torch.launch.federated --pods 4 \
        --rounds 5 [--full-config --num-layers N] [--device cpu]

The counterpart of ``repro.launch.federated``: the server's allocation LP
(``core/allocation.py``) turns per-pod telemetry (link rates, step
times) into per-round dropout rates; each pod takes ``local_steps``
plain-SGD steps on its shard of a synthetic token stream; then every
leaf is exchanged across the pods, a 1-D leaf by the dense mean and a
rank-2+ leaf by FedDD's compacted top-k all-gather with the Eq. (20)
importance of its last-axis channels (``core.sparse_collective``).

The pods are the shards of a :class:`~repro_torch.launch.mesh.ClientMesh`
driven by one process, as the JAX driver's ``shard_map`` drives its
``pod`` axis; ``--pods`` beyond the visible devices repeats them
(virtual pods on one card).  The compaction buffer holds ``k = ceil(C *
k_frac)`` channels, ``k_frac`` the smallest rate's keep fraction
bucketed to 1/16; each pod zero-weights the rows past its own
``ceil(C * (1 - D_n))``.  The JAX driver bucketed k to bound its
recompiles; nothing here compiles, but the bucket sets k, so it stays.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.allocation import ClientTelemetry, solve_dropout_rates
from repro_torch.core.importance import channel_importance
from repro_torch.core.sparse_collective import (dense_allreduce_mean,
                                                sparse_allgather_mean)
from repro_torch.data import make_lm_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import ClientMesh, _visible
from repro_torch.models import lm


def pod_telemetry(n_pods: int, model_bytes: float, seed: int = 0
                  ) -> ClientTelemetry:
    """Cross-pod DCN links are the heterogeneous resource (Table-4 analog:
    pods on different network fabrics / distances)."""
    rng = np.random.default_rng(seed)
    return ClientTelemetry(
        model_bytes=np.full(n_pods, model_bytes),
        uplink_rate=rng.uniform(25e9, 100e9, n_pods),      # bytes/s DCN
        downlink_rate=rng.uniform(25e9, 100e9, n_pods),
        compute_latency=rng.uniform(0.5, 2.0, n_pods),     # local step time
        num_samples=np.full(n_pods, 1.0),
        label_coverage=np.full(n_pods, 1.0),
        train_loss=np.ones(n_pods),
    )


def pod_mesh(n_pods: int, device=None) -> ClientMesh:
    """``n_pods`` pods over the visible devices of ``device``'s type, in
    turn (more pods than devices: virtual pods)."""
    devs = _visible(device)
    return ClientMesh(tuple(devs[i % len(devs)] for i in range(n_pods)),
                      axis_names=("pod",))


def local_sgd(params, cfg, tokens: torch.Tensor, lr: float,
              local_steps: int):
    """``local_steps`` plain-SGD steps of ``lm.loss_fn`` (no remat) on one
    pod's replica, each update taken in fp32 and cast back to the leaf's
    dtype: (params, the last step's loss)."""
    loss = None
    for _ in range(local_steps):
        loss, _, grads = lm.value_and_grad(params, cfg, {"tokens": tokens},
                                           remat=False)
        with torch.no_grad():
            params = tree.tree_map(
                lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                params, grads)
        del grads
    return params, loss


def keep_counts(c: int, d: Sequence[float]) -> List[int]:
    """Each pod's ``ceil(C * (1 - D_n))``, in float32 as the JAX driver
    computes it from its traced float32 rate."""
    d32 = np.asarray(d, np.float32)
    return [int(v) for v in np.ceil(np.float32(c) * (np.float32(1.0) - d32))]


def exchange(olds: Sequence, news: Sequence, mesh: ClientMesh,
             k_frac: float, d: Optional[Sequence[float]],
             dense: bool = False) -> list:
    """FedDD's exchange of every leaf across the pods: per-pod parameter
    trees before (``olds``) and after (``news``) the local steps -> the
    per-pod trees after aggregation.  ``d`` (the pods' rates) caps each
    pod's rows at ``ceil(C * (1 - D_n))``; ``None`` keeps all ``k``.
    ``dense`` takes the dense mean at every leaf (the FedAvg baseline)."""
    old_l = [tree.flatten(o)[0] for o in olds]
    new_l, td = [], None
    for n in news:
        leaves, td = tree.flatten(n)
        new_l.append(leaves)
    out = [[] for _ in news]
    for li in range(len(new_l[0])):
        news_li = [nl[li] for nl in new_l]
        if dense or news_li[0].ndim <= 1:
            agg = dense_allreduce_mean(news_li, mesh)
        else:
            c = news_li[0].shape[-1]
            k = max(1, int(math.ceil(c * k_frac)))
            k_loc = ([k] * len(news_li) if d is None else
                     [min(kn, k) for kn in keep_counts(c, d)])
            # Eq. (20) over the last-axis channels, the leaf read in place
            scores = [channel_importance(ol[li], n, channel_axis=-1)
                      for ol, n in zip(old_l, news_li)]
            agg = sparse_allgather_mean(
                [n.movedim(-1, 0) for n in news_li], scores, k, mesh,
                k_local=None if d is None else k_loc)
            agg = [a.movedim(0, -1).contiguous() for a in agg]
        for o, a in zip(out, agg):
            o.append(a)
    return [tree.unflatten(td, o) for o in out]


def make_round_fn(cfg, mesh: ClientMesh, lr: float, local_steps: int,
                  k_frac: float):
    """round_fn(pod_params, pod_tokens, d) -> (pod_params,
    losses (P,) fp32 on the mesh's first device): each pod's local steps,
    then :func:`exchange`.  ``pod_params[p]`` and ``pod_tokens[p]`` (B, S)
    live on ``mesh.devices[p]``; ``d`` holds the pods' dropout rates."""

    def round_fn(pod_params, pod_tokens, d):
        news, losses = [], []
        for params, toks in zip(pod_params, pod_tokens):
            p_new, loss = local_sgd(params, cfg, toks, lr, local_steps)
            news.append(p_new)
            losses.append(loss.to(mesh.devices[0]))
        out = exchange(pod_params, news, mesh, k_frac, d)
        return out, torch.stack(losses)

    return round_fn


def k_bucket(d: np.ndarray) -> float:
    """The buffer's keep fraction: ``1 - min D`` rounded up to 1/16."""
    return float(np.ceil((1.0 - np.min(d)) * 16) / 16)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite_3_8b", choices=ARCH_IDS)
    ap.add_argument("--pods", type=int, default=0,
                    help="pods (0: one per visible device)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--a-server", type=float, default=0.6)
    ap.add_argument("--d-max", type=float, default=0.8)
    ap.add_argument("--delta", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--full-config", action="store_true",
                    help="the published widths (default: the reduced "
                         "config)")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    n_pods = args.pods or len(_visible(dev))
    mesh = pod_mesh(n_pods, dev)
    cfg = get_config(args.arch, reduced=not args.full_config)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_model(cfg, gen, dev)
    pbytes = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    tel = pod_telemetry(n_pods, pbytes)
    pods = [tree.tree_map(lambda t, d_=d_: t.to(d_, copy=True), params)
            for d_ in mesh.devices]
    del params
    toks = make_lm_dataset(vocab_size=cfg.vocab_size,
                           num_tokens=n_pods * 20_000, seed=0)
    shards = toks.reshape(n_pods, -1)

    losses = np.ones(n_pods)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    out = []
    for r in range(1, args.rounds + 1):
        t_round = time.perf_counter()
        tel_r = dataclasses.replace(tel, train_loss=losses)
        alloc = solve_dropout_rates(tel_r, a_server=args.a_server,
                                    d_max=args.d_max, delta=args.delta,
                                    global_model_bytes=pbytes)
        k_frac = k_bucket(alloc.dropout_rates)
        round_fn = make_round_fn(cfg, mesh, args.lr, args.local_steps,
                                 k_frac)
        starts = rng.integers(0, shards.shape[1] - args.seq - 1,
                              (n_pods, args.batch))
        batch = [torch.from_numpy(np.stack(
            [shards[p, s:s + args.seq] for s in starts[p]])).to(d_)
            for p, d_ in enumerate(mesh.devices)]
        pods, lvec = round_fn(pods, batch, alloc.dropout_rates)
        losses = lvec.double().cpu().numpy()      # waits for the device
        out.append(dict(round=r, d=alloc.dropout_rates.copy(),
                        k_frac=k_frac, losses=losses.copy(),
                        seconds=time.perf_counter() - t_round))
        print(f"round {r}: D=[{alloc.dropout_rates.min():.2f},"
              f"{alloc.dropout_rates.max():.2f}] k_frac={k_frac:.3f} "
              f"mean_loss={losses.mean():.4f} "
              f"t_server={alloc.t_server:.2f}s "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    print("done.")
    return pods, out


if __name__ == "__main__":
    main()
