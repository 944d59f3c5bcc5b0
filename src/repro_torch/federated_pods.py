"""End-to-end driver: FedDD federated pre-training of a transformer across
pods (the port of ``examples/federated_pods.py``).

Each pod trains a local replica of a small LM on its own shard of a
synthetic token stream; every round the pods exchange only the
top-(1-D) channels of each parameter through the compacted sparse
all-gather (``core/sparse_collective.py``), aggregated per Eq. (4) with
the FedDD importance index (Eq. (20)) selecting the channels.

    PYTHONPATH=src python -m repro_torch.federated_pods --pods 4 \
        --rounds 10 [--dense] [--device cpu]

``--dense`` is the baseline: a dense mean of every leaf (FedAvg-style).
The pods are shards of a ``ClientMesh`` (more pods than devices: virtual
pods).  The weights are drawn from a torch generator seeded 0, the batch
offsets from ``np.random.default_rng(0)``, as ``launch/federated`` draws
them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.data import make_lm_dataset
from repro_torch.device import resolve_device
from repro_torch.launch import federated
from repro_torch.launch.mesh import _visible
from repro_torch.models import lm


def build(args):
    cfg = get_config("granite_3_8b", reduced=True)
    return dataclasses.replace(
        cfg, num_layers=args.layers, d_model=args.d_model,
        d_ff=args.d_model * 2, vocab_size=512,
        num_heads=4, num_kv_heads=2, head_dim=max(32, args.d_model // 4))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pods", type=int, default=0,
                    help="pods (0: one per visible device)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dropout-rate", type=float, default=0.5,
                    help="FedDD D: fraction of channels NOT exchanged")
    ap.add_argument("--dense", action="store_true",
                    help="baseline: dense all-reduce (FedAvg-style)")
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    n_pods = args.pods or len(_visible(dev))
    mesh = federated.pod_mesh(n_pods, dev)
    cfg = build(args)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_model(cfg, gen, dev)
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"pods={n_pods} params={n_params / 1e6:.2f}M  "
          f"D={args.dropout_rate} mode={'dense' if args.dense else 'feddd'}")

    pods = [tree.tree_map(lambda t, d_=d_: t.to(d_, copy=True), params)
            for d_ in mesh.devices]
    toks = make_lm_dataset(vocab_size=cfg.vocab_size,
                           num_tokens=n_pods * 50_000, seed=0)
    shards = toks.reshape(n_pods, -1)

    def sample_batch(starts, pod, d_):
        return torch.from_numpy(np.stack(
            [shards[pod, s:s + args.seq] for s in starts])).to(d_)

    d_rate = 0.0 if args.dense else args.dropout_rate
    full_bytes = sum(t.numel() * t.element_size()
                     for t in tree.leaves(params))
    del params
    print(f"per-round exchange (theoretical): "
          f"{(1 - d_rate) * full_bytes / 1e6:.2f} MB/pod "
          f"(dense would be {full_bytes / 1e6:.2f} MB)")

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    losses = None
    for r in range(1, args.rounds + 1):
        starts = rng.integers(0, shards.shape[1] - args.seq - 1,
                              (n_pods, args.batch))
        batches = [sample_batch(starts[p], p, d_)
                   for p, d_ in enumerate(mesh.devices)]
        news, losses = [], []
        for p_, b in zip(pods, batches):
            # every local step reuses the pod's batch, as the example does
            p_new, loss = federated.local_sgd(p_, cfg, b, args.lr,
                                              args.local_steps)
            news.append(p_new)
            losses.append(float(loss))
        pods = federated.exchange(pods, news, mesh, 1.0 - d_rate, None,
                                  dense=args.dense)
        del news
        print(f"round {r:3d}  mean_loss={np.mean(losses):.4f}  "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    print("done.")
    return pods, losses


if __name__ == "__main__":
    main()
