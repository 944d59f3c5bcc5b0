"""Serving driver: batched autoregressive decode with a static KV cache
(ring-buffered on sliding-window layers).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_27b \
        --batch 4 --steps 32 [--device cpu]

The counterpart of ``repro.launch.serve``, with its flags, and
``--device`` (default: cuda).  ``--mesh D,M`` serves on a (data, model)
``LMMesh`` of the visible cards, clamped as the JAX package's
``make_host_mesh`` clamps; by default every card is on ``data`` (the JAX
package's ``make_host_mesh(len(jax.devices()))``), so one card runs
unmeshed.  ``--production-mesh`` asks for the reference's (16, 16)
mesh, which needs 256 cards.  ``--virtual`` asks for a mesh of that
shape whose shards all sit on the one device (``LMMesh.virtual``).
Every family serves on a mesh of several shards, as unmeshed.
``launch.dryrun``
accounts for the production meshes.  ``--reduced`` (the default)
picks the smoke-test variant of the architecture; ``--full-config`` the
published one.  Every architecture of the registry serves: an enc-dec
model (whisper) attends to the encoder's output over zero frames
(B, 24, D) in bf16, as the JAX package's driver feeds it; VLM decode is
text only.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import lm_mesh_from_flags
from repro_torch.models import lm


def sample_greedy(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_topk(logits: torch.Tensor, generator: torch.Generator,
                k: int = 40, temperature: float = 0.8) -> torch.Tensor:
    """Top-k sampling at ``temperature``, drawn from ``generator`` (not
    bit-equal to ``jax.random.categorical``)."""
    v, idx = torch.topk(logits / temperature, k, dim=-1)
    choice = torch.multinomial(torch.softmax(v, dim=-1), 1,
                               generator=generator)
    return torch.gather(idx, 1, choice)[:, 0].to(torch.int32)


def build(arch: str, *, reduced: bool = True, num_layers: int = 0,
          device=None, seed: int = 0):
    """The served model: ``arch``'s config (``num_layers`` > 0 cuts its
    depth) and params drawn on ``device`` from a generator seeded ``seed``.
    Returns (cfg, params, generator); the generator goes on to draw the
    requests' tokens."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, lm.init_model(cfg, gen, dev), gen


def generate(params, cfg, state: lm.DecodeState, tok: torch.Tensor,
             steps: int, sampler=sample_greedy,
             generator: Optional[torch.Generator] = None, mesh=None):
    """``steps`` serve steps from ``tok`` (B, 1), each fed the token sampled
    from the last.  Returns (tokens (B, steps + 1), last logits, state).
    On a ``mesh``, ``params`` and ``state`` are placed on it."""
    serve = lm.make_serve_step(cfg, mesh)
    outs, logits = [tok], None
    for _ in range(steps):
        logits, state = serve(params, state, tok)
        tok = sampler(logits, generator)[:, None]
        outs.append(tok)
    return torch.cat(outs, dim=1), logits, state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3_27b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=0)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    ap.add_argument("--sample", choices=("greedy", "topk"), default="topk")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="(data, model) mesh of the visible devices "
                         "(default: every one on data)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's (16, 16) mesh (256 devices)")
    ap.add_argument("--virtual", action="store_true",
                    help="put every shard of the mesh on the one device")
    args = ap.parse_args(argv)

    mesh = lm_mesh_from_flags(args.device, shape=args.mesh,
                              virtual=args.virtual,
                              production=args.production_mesh)
    dev = mesh.devices[0]
    cfg, params, gen = build(args.arch, reduced=args.reduced, device=dev)
    cache_len = args.cache_len or args.steps + 8
    sampler = sample_topk if args.sample == "topk" else sample_greedy
    on_mesh = mesh if mesh.size > 1 else None
    if on_mesh is not None:
        params = lm.place_params(params, cfg, mesh)

    enc = (torch.zeros((args.batch, 24, cfg.d_model), dtype=torch.bfloat16,
                       device=dev) if cfg.is_encdec else None)
    state = lm.init_decode_state(params, cfg, args.batch, cache_len,
                                 enc_frames=enc, mesh=on_mesh)
    tok = torch.randint(0, cfg.vocab_size, (args.batch, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    seq, _, _ = generate(params, cfg, state, tok, args.steps, sampler, gen,
                         mesh=on_mesh)
    seq = seq.cpu()                        # waits for the device
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={dev} mesh={mesh.axis_sizes}"
          f"{' virtual' if args.virtual else ''} batch={args.batch} "
          f"steps={args.steps} {dt / args.steps * 1e3:.1f} ms/token")
    print("request 0 token ids:", seq[0, :16].tolist(), "...")
    return seq


if __name__ == "__main__":
    main()
