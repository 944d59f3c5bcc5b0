"""Run one cell of the benchmark once, from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs an NVIDIA card (it fails without one and never falls back to the
CPU).  The last line of standard output is the result, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; the numbers compared to decide
``correct`` come last, under ``checks``, and again as the last lines of
standard error."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the CUDA driver's kernel cache inside the checkout, at a fixed path
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))
# one process with few threads: OpenMP and BLAS pools of one thread each
# (set before numpy and torch load them), so that no pool spins on the
# cores the thread that launches the kernels needs
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the load of one process with one intra-op thread: steadier runs
    torch.set_num_threads(1)
    result = harness.run_cell(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        device=torch.device("cuda", 0), t_start=T_START,
        log=lambda s: print(s, file=sys.stderr, flush=True))
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; it may import neither "
              f"JAX nor the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
