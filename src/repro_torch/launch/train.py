"""Training driver: the LM train step on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_8b \
        --steps 100 [--full-config --num-layers N] [--device cpu]

The counterpart of ``repro.launch.train``, with its flags, log lines,
batch draws (``np.random.default_rng(0)`` over ``make_lm_dataset``; zero
patch embeddings for a VLM, zero frames (B, 24, D) for enc-dec) and
optimizer (``launch.specs.policy_for``: adafactor at 10x the learning
rate where the policy says so, else AdamW).  The port trains on one
card: the JAX package trains on its host or production mesh, and
training on the port's ``LMMesh`` (FSDP gradients reduced over ``data``,
the tensor-parallel backward) is ROADMAP A19 item 2; the mesh serves
already (``launch.serve --mesh``).  ``--device`` (default: cuda) picks
the card or the CPU.
``--num-layers`` cuts the depth, as ``launch.serve.build`` does.
Checkpoints go through ``repro_torch.checkpoint.save_checkpoint``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import make_lm_dataset
from repro_torch.device import resolve_device
from repro_torch.launch import specs as specs_mod
from repro_torch.models import lm
from repro_torch.optim import adafactor, adamw


def optimizer_for(cfg, lr: float):
    """The optimizer ``policy_for(cfg)`` names, at the driver's rates."""
    pol = specs_mod.policy_for(cfg)
    return adafactor(lr * 10) if pol.optimizer == "adafactor" else adamw(lr)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite_3_8b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    opt = optimizer_for(cfg, args.lr)
    print(f"arch={cfg.name} reduced={args.reduced} device={dev}")

    toks = make_lm_dataset(vocab_size=cfg.vocab_size,
                           num_tokens=1 << 18, seed=0)

    gen = torch.Generator(device=dev).manual_seed(0)
    state = lm.init_train_state(cfg, opt, gen, dev)
    step_fn = lm.make_train_step(cfg, opt)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    metrics = {}
    for step in range(1, args.steps + 1):
        starts = rng.integers(0, len(toks) - args.seq - 1, args.batch)
        batch_tok = np.stack([toks[s:s + args.seq] for s in starts])
        batch = {"tokens": torch.from_numpy(batch_tok).to(dev)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (args.batch, cfg.num_patch_tokens, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        if cfg.family == "audio":
            batch["enc_frames"] = torch.zeros(
                (args.batch, 24, cfg.d_model), dtype=torch.bfloat16,
                device=dev)
        state, metrics = step_fn(state, batch)
        if step % max(1, args.steps // 10) == 0 or step == 1:
            print(f"step {step:5d}  loss={float(metrics['loss']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}  "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if args.checkpoint_every and step % args.checkpoint_every == 0:
            save_checkpoint(
                Path(args.checkpoint_dir) / f"{cfg.name}_{step}.npz",
                state.params, metadata={"step": step})
    print("done.")
    return state, metrics


if __name__ == "__main__":
    main()
