#!/usr/bin/env python3
"""Does a conv model's training repeat bit for bit on the card?

    python3 scripts/conv_determinism.py [--rounds 2] [--out PATH]

Runs the paper's model-heterogeneous configuration
(``python -m repro_torch.heterogeneous``: the five Table 3 VGG
sub-models at full width, synthetic CIFAR-10 3000/800) through the
per-client loop twice with cuDNN's default convolution algorithms
(``torch.backends.cudnn.deterministic = False``) and twice with its
deterministic ones (the port's trainers set True), and once more with
the grouped engine in the deterministic setting.  For each setting it
prints the largest |difference| of the global parameters between its two
loop runs, and whether their mean losses agree; for the grouped run the
same against the deterministic loop run.  One JSON line naming the card;
without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(loop: bool, rounds: int, deterministic: bool):
    import torch
    from repro_torch.heterogeneous import server_for, setup
    gp, clients, tel, ltf, ef = setup(device="cuda")
    # after setup: the trainers set the flag to True when they are built
    torch.backends.cudnn.deterministic = deterministic
    res = server_for(gp, clients, tel, rounds=rounds, loop=loop,
                     device="cuda").run(ltf, ef)
    torch.cuda.synchronize()
    return res


def _diff(a, b) -> dict:
    from repro_torch import tree
    d = max((x.float() - y.float()).abs().max().item() for x, y in zip(
        tree.leaves(a.global_params), tree.leaves(b.global_params)))
    return dict(global_max_abs_diff=d, mean_loss_equal=[
        x.mean_loss == y.mean_loss for x, y in zip(a.history, b.history)])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("conv_determinism needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = dict(card=card, rounds=args.rounds)
    for det in (False, True):
        a = _run(True, args.rounds, det)
        b = _run(True, args.rounds, det)
        out[f"loop_vs_loop_deterministic_{det}"] = _diff(a, b)
        if det:
            g = _run(False, args.rounds, det)
            out["grouped_vs_loop_deterministic_True"] = _diff(g, a)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
