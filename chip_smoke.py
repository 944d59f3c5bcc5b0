#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failure exits non-zero before the final ``ok`` line:

1. the card: its name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels of ``src/repro_torch/csrc`` (one nvcc call,
   sm_90a) and print the build seconds;
3. hold each kernel against its plain PyTorch version on the card, in
   fp32 and bf16, at the MLP's leaves (N=10), at ragged edges and at large
   leaves (a VGG conv and CNN2's fc), with the tolerances of the CPU tests
   (the Eq. (5) merge exact); time the kernel, the plain version and, where
   one PyTorch call computes the same function, that call (a yardstick the
   port never uses), as medians of CUDA-event pairs with a cold L2;
4. one engine step on the card against the same step on the CPU (the
   plain versions), for a FedDD round, a full FedDD round and FedAvg;
5. the main path: the quickstart configuration (synthetic MNIST 6000/1500,
   10 clients, the paper's MLP, A_server=0.6, h=5, lr 0.1) for 5 FedDD
   rounds and then 3 FedAvg rounds on cuda, with every kernel's launch
   count set to 0 just before and read just after.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  ``--out`` also writes
every measurement as JSON.  Without a CUDA device, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MLP_N = 10
MLP_LEAVES = [(784, 100), (100,), (100, 64), (64,), (64, 10), (10,)]
RAGGED = [(7, (257, 513)), (3, (3, 3)), (5, (1000, 7)), (2, (33,))]
# the full-width VGG conv of the Table 3 fleet, and CNN2's first fc
LARGE = [(16, (3, 3, 512, 512)), (16, (1024, 500))]
MAIN_SHAPE = (MLP_N, (784, 100))     # fc0.w, the main path's largest leaf
SLEEP_CYCLES = 40_000_000            # ~20 ms of device time ahead of a burst
TIMED_LAUNCHES = 30

KERNEL_INFO = {
    "importance": dict(
        source="src/repro_torch/csrc/importance.cu",
        replaces="src/repro/kernels/importance/importance.py:56"),
    "sparse_agg": dict(
        source="src/repro_torch/csrc/sparse_agg.cu",
        replaces="src/repro/kernels/sparse_agg/sparse_agg.py:40"),
    "masked_merge": dict(
        source="src/repro_torch/csrc/masked_merge.cu",
        replaces="src/repro/kernels/masked_merge/masked_merge.py:31"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


class Card:
    """Peak rates of the card, from NVIDIA's data sheets (dense)."""

    def __init__(self, name: str):
        pcie = "PCIe" in name
        self.bytes_per_s = 2.0e12 if pcie else 3.35e12
        self.fp32_flops = 51e12 if pcie else 67e12

    def bound(self, nbytes: float, flops: float):
        t_bytes = nbytes / self.bytes_per_s * 1e3
        t_ops = flops / self.fp32_flops * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


def time_ms(fn, flush) -> float:
    """Median device time of ``fn`` over TIMED_LAUNCHES event pairs.

    A sleep kernel keeps the card busy while the host queues the burst,
    so each pair brackets device work and not the host's launch overhead;
    an L2-sized memset before each launch makes the inputs cold."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(TIMED_LAUNCHES)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_checks(card: Card, flush, records: list, dev="cuda",
                  timer=time_ms) -> dict:
    """Phase 3: every kernel against its plain version; returns per-kernel
    max_abs_err and the timings at the main path's shape."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.importance import ops as imp_ops
    from repro_torch.kernels.importance.ref import channel_importance_ref
    from repro_torch.kernels.masked_merge import ops as merge_ops
    from repro_torch.kernels.masked_merge.ref import masked_merge_ref
    from repro_torch.kernels.sparse_agg import ops as agg_ops
    from repro_torch.kernels.sparse_agg.ref import masked_weighted_sum_ref

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {k: 0.0 for k in KERNEL_INFO}
    main = {}
    shapes = ([(MLP_N, leaf) for leaf in MLP_LEAVES] + RAGGED + LARGE)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        for n, leaf in shapes:
            a, c, b = _lib.split_at(leaf, len(leaf) - 1)
            r = a * b
            elems = n * r * c
            is_main = (n, leaf) == MAIN_SHAPE and dtype == torch.float32

            # ---- importance (Eq. (20)/(21))
            wo = randn(n, *leaf).to(dtype)
            wn = (wo.float() + 0.1 * randn(n, *leaf)).to(dtype)
            for cov in (None, torch.rand((c,), generator=gen, device=dev)
                        + 0.5):
                got = imp_ops.channel_importance_batched(wo, wn,
                                                         coverage=cov)
                want = channel_importance_ref(wo.view(n, a, c, b),
                                              wn.view(n, a, c, b), cov)
                torch.testing.assert_close(got, want, rtol=5e-5, atol=1e-5)
                max_err["importance"] = max(
                    max_err["importance"], (got - want).abs().max().item())
            kern = lambda: imp_ops.channel_importance_batched(wo, wn)  # noqa
            plain = lambda: channel_importance_ref(                     # noqa
                wo.view(n, a, c, b), wn.view(n, a, c, b))
            rec = _timed(card, flush, timer, "importance", n, leaf, dtype,
                         kern,
                         plain, None, 2 * elems * es + n * c * 4, 5 * elems)
            records.append(rec)
            if is_main:
                main["importance"] = rec

            # ---- sparse_agg (Eq. (4) partials), channel and dense masks
            vals = randn(n, *leaf).to(dtype)
            wts = torch.rand((n,), generator=gen, device=dev) + 0.5
            mshape = (n,) + (1,) * (len(leaf) - 1) + (c,)
            chan = (torch.rand(mshape, generator=gen, device=dev)
                    > 0.5).to(dtype)
            dense = torch.ones((n,) + (1,) * len(leaf), dtype=dtype,
                               device=dev)
            for mask, mc in ((chan, c), (dense, 1)):
                num, den = agg_ops.masked_weighted_sum(vals, mask, wts)
                wnum, wden = masked_weighted_sum_ref(
                    vals.view(n, a, c, b), mask.view(n, mc), wts)
                torch.testing.assert_close(
                    num, wnum.view(leaf),
                    rtol=5e-3 if dtype == torch.bfloat16 else 3e-5,
                    atol=1e-4)
                torch.testing.assert_close(den, wden.view(leaf), rtol=3e-5,
                                           atol=1e-5)
                max_err["sparse_agg"] = max(
                    max_err["sparse_agg"],
                    (num - wnum.view(leaf)).abs().max().item(),
                    (den - wden.view(leaf)).abs().max().item())
            v3 = vals.view(n, a, c)          # channels last: b == 1
            m2 = chan.view(n, c)
            kern = lambda: agg_ops.masked_weighted_sum(vals, chan, wts)  # noqa
            plain = lambda: masked_weighted_sum_ref(                     # noqa
                vals.view(n, a, c, b), m2, wts)
            lib = lambda: torch.einsum(                                  # noqa
                "n,nrc,nc->rc", wts.to(dtype), v3, m2)
            rec = _timed(card, flush, timer, "sparse_agg", n, leaf, dtype,
                         kern,
                         plain, lib,
                         elems * es + n * c * es + n * 4 + 2 * r * c * 4,
                         5 * elems)
            records.append(rec)
            if is_main:
                main["sparse_agg"] = rec

            # ---- masked_merge (Eq. (5)): an exact select
            g = randn(*leaf).to(dtype)
            loc = randn(n, *leaf).to(dtype)
            out = merge_ops.masked_merge(g, loc, chan)
            want = masked_merge_ref(g.view(a, c, b), loc.view(n, a, c, b),
                                    m2).view(loc.shape)
            if not torch.equal(out, want):
                raise AssertionError(f"masked_merge differs from its plain "
                                     f"version at {(n,) + leaf} {dtype}")
            sel = torch.where(chan.bool(), g[None], loc)
            if not torch.equal(out, sel):
                raise AssertionError("masked_merge is not a select of G "
                                     "and L for a binary mask")
            dense_out = merge_ops.masked_merge(g, loc, dense)
            if not torch.equal(dense_out, g[None].expand_as(loc)):
                raise AssertionError("masked_merge with an all-ones mask is "
                                     "not the global")
            kern = lambda: merge_ops.masked_merge(g, loc, chan)  # noqa
            plain = lambda: masked_merge_ref(                    # noqa
                g.view(a, c, b), loc.view(n, a, c, b), m2)
            cb = chan.bool()
            lib = lambda: torch.where(cb, g[None], loc)          # noqa
            rec = _timed(card, flush, timer, "masked_merge", n, leaf, dtype,
                         kern,
                         plain, lib, 2 * elems * es + r * c * es + n * c * es,
                         4 * elems)
            records.append(rec)
            if is_main:
                main["masked_merge"] = rec
    return {"max_abs_err": max_err, "main": main}


def _timed(card, flush, timer, name, n, leaf, dtype, kern, plain, lib,
           nbytes, flops) -> dict:
    bound_ms, bound_by = card.bound(nbytes, flops)
    rec = dict(kernel=name, shape=[n, *leaf], dtype=str(dtype).split(".")[-1],
               ms=timer(kern, flush), plain_ms=timer(plain, flush),
               library_ms=None if lib is None else timer(lib, flush),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops)
    lib_col = ("-" if rec["library_ms"] is None
               else f"{rec['library_ms'] * 1e3:.1f}")
    print(f"  {name:12s} {str(tuple(rec['shape'])):22s} {rec['dtype']:8s} "
          f"kernel {rec['ms'] * 1e3:8.1f} us  plain "
          f"{rec['plain_ms'] * 1e3:8.1f} us  library {lib_col:>8s} us  "
          f"bound {bound_ms * 1e3:7.2f} us ({bound_by})", flush=True)
    return rec


def engine_check(dev="cuda") -> None:
    """Phase 4: one engine step on the card vs the same step on the CPU."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.core.round_engine import (BatchedRoundEngine,
                                               stack_pytrees)
    from repro_torch.fl import MLP_SPEC, init_cnn_spec

    rng = np.random.default_rng(0)
    gp = init_cnn_spec(MLP_SPEC, seed=1, device="cpu")
    old = stack_pytrees([tree.tree_map(
        lambda x: x + torch.from_numpy(
            rng.normal(0, 0.05, x.shape).astype(np.float32)), gp)
        for _ in range(MLP_N)])
    new = tree.tree_map(lambda x: x + torch.from_numpy(
        rng.normal(0, 0.02, x.shape).astype(np.float32)), old)
    rates = rng.uniform(0.0, 0.8, MLP_N)
    weights = rng.integers(100, 1000, MLP_N).astype(float)
    engine = BatchedRoundEngine()
    on_dev = lambda t: tree.tree_map(lambda x: x.to(dev), t)  # noqa: E731
    for full, dense in ((False, False), (True, False), (True, True)):
        want = engine.step(old, new, gp, rates, weights, full_round=full,
                           dense_masks=dense)
        got = engine.step(on_dev(old), on_dev(new), on_dev(gp), rates,
                          weights, full_round=full, dense_masks=dense)
        torch.testing.assert_close(got.densities.cpu(), want.densities,
                                   rtol=0, atol=0)
        for part in ("global_params", "client_params"):
            for g, w in zip(tree.leaves(getattr(got, part)),
                            tree.leaves(getattr(want, part))):
                if g.device.type != torch.device(dev).type:
                    raise AssertionError(f"{part} left the {dev} device")
                torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)
        print(f"  engine step full_round={full} dense_masks={dense}: {dev} "
              f"matches cpu", flush=True)


def main_path(dev="cuda") -> dict:
    """Phase 5: the quickstart configuration on cuda, kernels counted."""
    import numpy as np
    import torch
    from repro_torch import kernels, tree
    from repro_torch.core.baselines import round_times
    from repro_torch.quickstart import run

    def show(scheme, r):
        print(f"  {scheme:6s} round {r.round}  acc="
              f"{r.metrics['accuracy']:.4f}  loss={r.mean_loss:.5f}  "
              f"sim_t={r.sim_time:.1f}s  uploaded="
              f"{r.uploaded_fraction:.4f}  host={r.host_wall_time:.4f}s",
              flush=True)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    feddd, fedavg, tel = run(5, fedavg_rounds=3, device=dev,
                             on_round=show)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"  main path: {wall:.2f} s, launches {counts}", flush=True)

    for res in (feddd, fedavg):
        for rec in res.history:
            if not math.isfinite(rec.mean_loss):
                raise AssertionError(f"round {rec.round}: loss "
                                     f"{rec.mean_loss}")
        if not all(l.device.type == torch.device(dev).type
                   for l in tree.leaves(res.global_params)):
            raise AssertionError("global params left the card")
    for name, k in counts.items():
        if k <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    want_t1 = float(np.max(round_times(tel, np.zeros(tel.num_clients))))
    if feddd.history[0].sim_time != want_t1:
        raise AssertionError(f"round 1 sim_time {feddd.history[0].sim_time} "
                             f"!= Eq. (12) at D=0 {want_t1}")
    for rec in feddd.history[1:]:
        if not 0.55 <= rec.uploaded_fraction <= 0.65:
            raise AssertionError(f"round {rec.round} uploaded "
                                 f"{rec.uploaded_fraction}")
    acc = feddd.history[4].metrics["accuracy"]
    if acc < 0.85:
        raise AssertionError(f"accuracy after round 5 is {acc} < 0.85")
    return dict(
        launches=counts, wall_s=wall,
        rounds=[dict(scheme=s, round=r.round, acc=r.metrics["accuracy"],
                     loss=r.mean_loss, sim_time=r.sim_time,
                     uploaded_fraction=r.uploaded_fraction,
                     host_wall_time=r.host_wall_time)
                for s, res in (("feddd", feddd), ("fedavg", fedavg))
                for r in res.history])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement here as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: {e}",
              file=sys.stderr)
        return 2
    try:
        line = card_line()
        print(line, flush=True)
        card = Card(line)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}", flush=True)

        path, secs, log = kernels.build()
        print(f"build: {secs:.2f} s -> {path.name}", flush=True)
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {ln.strip()}")

        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        records: list = []
        checks = kernel_checks(card, flush, records)
        del flush
        engine_check()
        path_out = main_path()
        torch.cuda.synchronize()
    except Exception:      # any failed phase: report it and exit non-zero
        traceback.print_exc()
        return 1

    line_kernels = []
    for name, info in KERNEL_INFO.items():
        rec = checks["main"][name]
        line_kernels.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"],
            launches=path_out["launches"][name],
            max_abs_err=checks["max_abs_err"][name], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"]))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=line, build_s=secs, kernels=records, main_path=path_out,
            summary=line_kernels), indent=1))
    print(json.dumps({"kernels": line_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
