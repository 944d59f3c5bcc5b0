#!/usr/bin/env python3
"""Time the port's LM train step on one NVIDIA GPU, for an A/B of two
copies of the package.

    python3 scripts/bench_train_step.py [--src DIR] [--steps 3]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``) and times ``chip_smoke.py``'s phase 7 step: granite-3-8b at full
width cut to 8 layers, AdamW, 8 microbatches of 1 x 2048 tokens, seeded
random weights and tokens; then one AdamW step of qwen3-moe-30b-a3b at
full width cut to 4 layers on 4 x 1024 tokens.  After one warm-up step
each, it prints one JSON line: the card, the source, the seconds of each
timed step (host clock ending in a synchronise), their median, tokens/s,
the losses and the peak memory.  Compare two copies only within one
call, in the order parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch import specs, train
    from repro_torch.models import lm

    dev = resolve_device(None)
    out = dict(card=smoke.card_line(), src=args.src)

    def timed(name, cfg, opt, microbatches, batch, seq):
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = lm.init_train_state(cfg, opt, gen, dev)
        step = lm.make_train_step(cfg, opt, microbatches)
        toks = torch.randint(0, cfg.vocab_size, (args.steps + 1, batch, seq),
                             generator=gen, device=dev)
        secs, losses = [], []
        for i in range(args.steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, {"tokens": toks[i]})
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
        med = statistics.median(secs[1:])
        out[name] = dict(step_s=secs[1:], s_per_step=med,
                         tokens_per_s=batch * seq / med, losses=losses,
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del state, m

    cfg = dataclasses.replace(get_config(smoke.TRAIN_ARCH),
                              num_layers=smoke.TRAIN_LAYERS)
    timed("granite", cfg, train.optimizer_for(cfg, 3e-4),
          specs.policy_for(cfg).num_microbatches, smoke.TRAIN_BATCH,
          smoke.TRAIN_SEQ)
    cfg = dataclasses.replace(get_config(smoke.MOE_ARCH),
                              num_layers=smoke.MOE_LAYERS)
    timed("moe", cfg, train.optimizer_for(cfg, 3e-4), 1,
          smoke.MOE_TRAIN_BATCH, smoke.MOE_TRAIN_SEQ)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
