"""Training: the LM train step on a card or a mesh of them.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_8b \
        --steps 100 [--full-config --num-layers N] [--device cpu] \
        [--mesh D,M [--virtual] | --production-mesh [--multi-pod]]

The counterpart of ``repro.launch.train``, with its flags, log lines,
batch draws (``np.random.default_rng(0)`` over ``make_lm_dataset``; zero
patch embeddings for a VLM, zero frames (B, 24, D) for enc-dec) and
optimizer (``launch.specs.policy_for``: adafactor at 10x the learning
rate where the policy says so, else AdamW).  Like the JAX package, it
trains on a mesh: by default every visible card on ``data`` (the JAX
package's ``make_host_mesh(len(jax.devices()))``; one card trains
unmeshed), ``--mesh D,M`` a (data, model) ``LMMesh`` of the visible
cards, ``--production-mesh [--multi-pod]`` the reference's (16, 16) or
(2, 16, 16) one (256 or 512 cards), and ``--virtual`` that shape with
every shard on the one device.  On a mesh of several shards the state
is placed by ``lm.place_train_state``; every family of the registry
trains there.  ``--device`` (default:
cuda) picks the card or the CPU.  ``--num-layers`` cuts the depth, as
``launch.serve.build`` does.  Checkpoints go through
``repro_torch.checkpoint.save_checkpoint``; on a mesh they hold the
gathered parameters, the file an unmeshed run writes.
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
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import lm_mesh_from_flags
from repro_torch.models import lm, sharding
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
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="(data, model) mesh of the visible devices "
                         "(default: every one on data)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--virtual", action="store_true",
                    help="put every shard of the mesh on the one device")
    args = ap.parse_args(argv)

    mesh = lm_mesh_from_flags(args.device, shape=args.mesh,
                              virtual=args.virtual,
                              production=args.production_mesh,
                              multi_pod=args.multi_pod)
    dev = mesh.devices[0]
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    opt = optimizer_for(cfg, args.lr)
    print(f"arch={cfg.name} reduced={args.reduced} device={dev} "
          f"mesh={mesh.shape}{' virtual' if args.virtual else ''}")

    toks = make_lm_dataset(vocab_size=cfg.vocab_size,
                           num_tokens=1 << 18, seed=0)

    gen = torch.Generator(device=dev).manual_seed(0)
    state = lm.init_train_state(cfg, opt, gen, dev)
    on_mesh = mesh if mesh.size > 1 else None
    if on_mesh is not None:
        state = lm.place_train_state(state, cfg, mesh)
    step_fn = lm.make_train_step(cfg, opt, mesh=on_mesh)
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
                state.params if on_mesh is None
                else sharding.gather(state.params),
                metadata={"step": step})
    print("done.")
    return state, metrics


if __name__ == "__main__":
    main()
