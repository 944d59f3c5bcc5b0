#!/usr/bin/env python3
"""Where the LM training paths' time goes: ``torch.profiler`` traces of
one train step, one FedDD round across pods and one MoE train step of the
port on one NVIDIA GPU.

    python3 scripts/profile_training.py [--out PATH]

The models and batches are ``chip_smoke.py``'s phases 7-9: granite-3-8b
at full width cut to 8 layers (AdamW, 8 microbatches of 1 x 2048), the
same model cut to 4 layers on 4 virtual pods (2 local SGD steps on 8 x
256 tokens, every leaf exchanged at one pod-specific rate), and
qwen3-moe-30b-a3b at full width cut to 4 layers (one AdamW step at 4 x
1024).  Each is traced after a warm-up call; for each window it prints
the wall time (host clock, ending in a synchronise), the device time
summed over kernels, the idle share, the kernel launches, the device
time by kernel group (``profile_serving.GROUPS``) and the top kernels.
Without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "scripts"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as smoke
    from profile_serving import show, summarise
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch import federated, specs, train
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    dev = resolve_device(None)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = dict(card=smoke.card_line())
    print(out["card"], flush=True)

    def traced(name, fn):
        fn()                                        # warm-up
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[name] = summarise(prof, wall)
        show(name, out[name])

    # ---- one granite-3-8b train step
    cfg = dataclasses.replace(get_config(smoke.TRAIN_ARCH),
                              num_layers=smoke.TRAIN_LAYERS)
    opt = train.optimizer_for(cfg, 3e-4)
    gen = torch.Generator(device=dev).manual_seed(0)
    box = [lm.init_train_state(cfg, opt, gen, dev)]
    step = lm.make_train_step(cfg, opt,
                              specs.policy_for(cfg).num_microbatches)
    toks = torch.randint(0, cfg.vocab_size,
                         (smoke.TRAIN_BATCH, smoke.TRAIN_SEQ), generator=gen,
                         device=dev)

    def train_step():
        box[0], _ = step(box[0], {"tokens": toks})

    traced(f"train step {cfg.name} {cfg.num_layers} layers "
           f"{smoke.TRAIN_BATCH} x {smoke.TRAIN_SEQ}", train_step)
    del box, step

    # ---- one FedDD round across 4 virtual pods
    cfg = dataclasses.replace(get_config(smoke.TRAIN_ARCH),
                              num_layers=smoke.FED_LAYERS)
    params = lm.init_model(cfg, gen, dev)
    mesh = federated.pod_mesh(smoke.FED_PODS, dev)
    pods = [[tree.tree_map(lambda t: t.clone(), params)
             for _ in range(smoke.FED_PODS)]]
    del params
    d = np.linspace(0.0, 0.6, smoke.FED_PODS).astype(np.float32)
    round_fn = federated.make_round_fn(cfg, mesh, 3e-2,
                                       smoke.FED_LOCAL_STEPS,
                                       federated.k_bucket(d))
    batch = [torch.randint(0, cfg.vocab_size,
                           (smoke.FED_BATCH, smoke.FED_SEQ), generator=gen,
                           device=dev) for _ in range(smoke.FED_PODS)]

    def pods_round():
        pods[0], _ = round_fn(pods[0], batch, d)

    traced(f"pods round {smoke.FED_PODS} x {cfg.num_layers} layers",
           pods_round)
    del pods

    # ---- one qwen3-moe-30b-a3b AdamW step
    cfg = dataclasses.replace(get_config(smoke.MOE_ARCH),
                              num_layers=smoke.MOE_LAYERS)
    opt = adamw(3e-4)
    box = [lm.init_train_state(cfg, opt, gen, dev)]
    step = lm.make_train_step(cfg, opt)
    toks = torch.randint(0, cfg.vocab_size,
                         (smoke.MOE_TRAIN_BATCH, smoke.MOE_TRAIN_SEQ),
                         generator=gen, device=dev)

    def moe_step():
        box[0], _ = step(box[0], {"tokens": toks})

    traced(f"moe train step {cfg.name} {cfg.num_layers} layers", moe_step)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
