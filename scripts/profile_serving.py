#!/usr/bin/env python3
"""Where the serving path's time goes: a ``torch.profiler`` trace of one
prefill and of steady decode steps of the port's LM on one NVIDIA GPU.

    python3 scripts/profile_serving.py [--seq 32768] [--steps 8] [--out PATH]

The model and the decode batch are ``chip_smoke.py``'s serving phase:
gemma3-27b at full width (d 5376, 32/16 heads, hd 128, d_ff 21504, vocab
262144) cut to 12 layers, seeded random bf16 weights on the card, decode
at batch 4 with a 40-slot cache.  After a warm-up call of each, one
prefill of ``--seq`` tokens and ``--steps`` greedy decode steps are
traced.  For each window it prints the wall time (host clock, ending in a
synchronise), the device time summed over kernels, the idle share
(1 - device / wall), the kernel launches, the device time by kernel
group and the top kernels.  Without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# kernel-name fragments -> group, first match wins
GROUPS = (("flash_attention", ("flash_kernel", "flash_sm90_kernel")),
          ("gemm", ("gemm", "gemv", "xmma", "cutlass", "sm90_", "Kernel2",
                    "splitK", "nvjet")),
          ("softmax/reduce", ("softmax", "reduce", "Reduce")),
          ("copy/cast", ("copy", "Copy", "cast", "memcpy", "Memcpy",
                         "memset", "Memset", "fill", "Fill")),
          ("elementwise", ("elementwise", "Elementwise", "vectorized",
                           "unrolled")),
          ("index/cat", ("index", "Index", "cat", "Cat", "gather",
                         "scatter")))


def group_of(name: str) -> str:
    for group, frags in GROUPS:
        if any(f in name for f in frags):
            return group
    return "other"


def summarise(prof, wall_s: float, top: int = 12) -> dict:
    from torch.autograd import DeviceType
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    groups: dict = {}
    for e in kern:
        g = group_of(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    ranked = sorted(kern, key=lambda e: -e.self_device_time_total)[:top]
    return dict(
        wall_ms=wall_s * 1e3, device_ms=dev_us / 1e3,
        idle_share=(1 - dev_us / 1e6 / wall_s) if kern else None,
        launches=sum(e.count for e in kern),
        groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        top=[dict(name=e.key[:120], ms=e.self_device_time_total / 1e3,
                  count=e.count) for e in ranked])


def show(title: str, res: dict) -> None:
    print(f"{title}: wall {res['wall_ms']:.2f} ms, device "
          f"{res['device_ms']:.2f} ms, idle share {res['idle_share']}, "
          f"{res['launches']} kernel launches", flush=True)
    for g, ms in res["groups_ms"].items():
        print(f"  {g:16s} {ms:10.3f} ms", flush=True)
    for t in res["top"]:
        print(f"    {t['ms']:10.3f} ms  x{t['count']:<5d} {t['name']}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as smoke
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import lm

    dev = resolve_device(None)

    def sync():
        torch.cuda.synchronize()

    cfg, params, gen = serve.build(smoke.SERVE_ARCH, reduced=False,
                                   num_layers=smoke.SERVE_LAYERS, device=dev)
    batch, cache = smoke.DECODE_BATCH, smoke.DECODE_CACHE
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = dict(arch=cfg.name, layers=cfg.num_layers, seq=args.seq,
               batch=batch, cache=cache, steps=args.steps,
               card=smoke.card_line())
    print(out["card"], flush=True)

    tokens = torch.randint(0, cfg.vocab_size, (1, args.seq), generator=gen,
                           device=dev)
    lm.prefill(params, cfg, {"tokens": tokens})        # warm-up
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        lm.prefill(params, cfg, {"tokens": tokens})
        sync()
        wall = time.perf_counter() - t0
    out["prefill"] = summarise(prof, wall)
    show(f"prefill B=1 S={args.seq}", out["prefill"])
    del tokens

    state = lm.init_decode_state(params, cfg, batch, cache)
    tok = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                        device=dev)
    seq, _, state = serve.generate(params, cfg, state, tok, 2)   # warm-up
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve.generate(params, cfg, state, seq[:, -1:], args.steps)
        sync()
        wall = time.perf_counter() - t0
    out["decode"] = summarise(prof, wall)
    show(f"decode B={batch} cache={cache}, {args.steps} steps",
         out["decode"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
