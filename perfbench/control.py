"""The readings a cell's limits are set from, many seeds in one process
(the benchmark's own runs do not run this):

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --mode program|tf32|half_batch|rates_altered [--out file.jsonl]

``program``: the program's checked rounds (the run's set-up, no window)
held against the reference: the lower readings.  ``tf32``: the control,
the reference computed with TF32 in the program's place: it has to come
out above the limits.  ``half_batch`` and ``rates_altered``: planted faults,
the reference in the program's place training every minibatch on half
its samples, or moving one allocated rate by 0.05.
Each seed prints one JSON line of the numbers ``perfbench.compare``
reads."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def readings(cell, seed: int, mode: str, device):
    """The numbers of one seed with the program (or its stand-in)."""
    from perfbench import harness, inputs as inputs_mod, program

    cfg, traffic = cell.cfg, cell.traffic
    inp = inputs_mod.make_inputs(cfg, traffic, seed, device)
    ref_inputs = harness.pristine(inp)
    if mode == "program":
        snap = harness.checked_rounds(program.build(cfg, traffic, inp),
                                      traffic)
    else:
        precision = "tf32" if mode == "tf32" else "fp32"
        fault = None if mode == "tf32" else mode
        snap = harness.reference(traffic).run_rounds(
            cfg, traffic, inp, traffic["check_rounds"],
            precision=precision, fault=fault)
    del inp
    return harness.check(cfg, traffic, ref_inputs, snap)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program",
                    choices=("program", "tf32", "half_batch", "rates_altered"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness
    cell = harness.load_cell(ROOT, args.workload)
    device = torch.device(args.device)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            values = readings(cell, seed, args.mode, device)
            line = json.dumps({"workload": args.workload, "mode": args.mode,
                               "seed": seed, "numbers": values,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
