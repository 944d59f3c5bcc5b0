#!/usr/bin/env python3
"""Time the port's three FedDD kernels, Eq. (4) of one leaf and one engine
step on one NVIDIA GPU, for the package under ``--src`` (default: this
checkout's).

    python3 scripts/bench_feddd_kernels.py [--src DIR] [--out PATH]

- ``importance``, ``sparse_agg`` (partials, and the mean mode where the
  package has it) and ``masked_merge`` at the six leaves of the paper's
  MLP with N = 10 clients in fp32, as the FedDD round calls them, and at
  ``chip_smoke.LARGE`` (the VGG conv and CNN2's fc) in fp32 and bf16;
- Eq. (4) of fc0 ``(10, 784, 100)`` both ways: the partials plus the
  eager ``finish_masked_mean``, and the mean mode (one launch); and
  ``sparse_agg`` at fc0 of 16 clients (``chip_smoke.SIM_FC0``), where
  the package has the ``select`` flag also with it on (both modes);
- ``masked_merge_where`` at every row: ``torch.where`` on the same
  operands, the yardstick of one PyTorch call (the port never calls it);
- Eq. (5) of the MLP's six leaves (fp32, N = 10) both ways: six
  single-leaf launches (each timed alone and summed, and back to back)
  and, where the package has it, the grouped launch of all six;
- one ``BatchedRoundEngine.step`` (a partial round: importance, masks,
  Eq. (4), Eq. (5)) over the quickstart's 10-client MLP fleet, inputs
  fixed by seed: ``step_span_ms`` is the median time between CUDA events
  around one step started on an idle card (host launch gaps included:
  the step synchronises once, for its density), ``step_ms`` the device
  time of its kernels and copies per step from ``torch.profiler``;
- where the package has the wire formats, the same step with a round key
  and ``CommConfig(auto, 8)`` (``engine_step_auto8``: int8 stochastic
  rounding of the uploads the aggregation reads, threefry noise drawn on
  the card, the measured mask overhead) and with random masks too
  (``engine_step_auto8_random``): the device ops and time the PRNG and
  the QDQ add to a step.

Kernel times are ``chip_smoke.time_ms`` (median of CUDA-event pairs, cold
L2), from a second sweep after a first that brings the card to its
clocks; step times are over ``STEP_REPS`` steps.  ``--src`` may be
another checkout's ``src``, so two versions are compared on one card in
one call (parent, change, change, parent): unpack the other commit with
``git archive`` under this checkout's git-ignored ``build/`` (e.g.
``build/parent``) and pass ``--src build/parent/src``; it builds its
kernels into its own checkout's ``build/``.  Prints one JSON line naming
the card; without a card it raises.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 10
STEP_REPS = 20


def _step_times(step):
    """(median ms between CUDA events around one step on an idle card,
    device ms per step from torch.profiler, device ops per step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        step()
    spans = []
    for _ in range(STEP_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(STEP_REPS):
            step()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in ops)
    return (statistics.median(spans), busy_us / STEP_REPS / 1e3,
            len(ops) / STEP_REPS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("bench_feddd_kernels needs a CUDA device")
    from repro_torch import kernels, tree
    from repro_torch.core import aggregation
    from repro_torch.core.round_engine import (BatchedRoundEngine,
                                               stack_pytrees)
    from repro_torch.fl import MLP_SPEC, init_cnn_spec
    from repro_torch.kernels.importance import ops as imp_ops
    from repro_torch.kernels.masked_merge import ops as merge_ops
    from repro_torch.kernels.sparse_agg import ops as agg_ops

    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    card = smoke.card_line()
    _, build_s, _ = kernels.build()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    has_mean = hasattr(agg_ops, "masked_weighted_mean")
    has_many = hasattr(merge_ops, "masked_merge_many")
    has_select = "select" in inspect.signature(
        agg_ops.masked_weighted_sum).parameters

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def ms(fn):
        return smoke.time_ms(fn, flush)

    fp32, bf16 = torch.float32, torch.bfloat16
    shapes = ([(N, leaf, fp32) for leaf in smoke.MLP_LEAVES]
              + [(*smoke.SIM_FC0, fp32)]
              + [(n, leaf, dt) for n, leaf in smoke.LARGE
                 for dt in (fp32, bf16)])

    def sweep():
        rows, eq4 = [], None
        for n, leaf, dt in shapes:
            c = leaf[-1]
            wo = randn(n, *leaf)
            wn = (wo + 0.1 * randn(n, *leaf)).to(dt)
            wo = wo.to(dt)
            mask = (torch.rand((n,) + (1,) * (len(leaf) - 1) + (c,),
                               generator=gen, device="cuda") > 0.5).to(dt)
            wts = torch.rand((n,), generator=gen, device="cuda") + 0.5
            g = randn(*leaf).to(dt)
            take_g = mask.bool()
            row = dict(
                shape=[n, *leaf], dtype=smoke._name(dt),
                importance=ms(lambda: imp_ops.channel_importance_batched(
                    wo, wn)),
                sparse_agg=ms(lambda: agg_ops.masked_weighted_sum(
                    wn, mask, wts)),
                sparse_agg_mean=ms(lambda: agg_ops.masked_weighted_mean(
                    wn, mask, wts, g, dt)) if has_mean else None,
                sparse_agg_select=ms(lambda: agg_ops.masked_weighted_sum(
                    wn, mask, wts, select=True)) if has_select else None,
                sparse_agg_mean_select=ms(
                    lambda: agg_ops.masked_weighted_mean(
                        wn, mask, wts, g, dt, select=True))
                if has_select else None,
                masked_merge=ms(lambda: merge_ops.masked_merge(g, wn,
                                                               mask)),
                masked_merge_where=ms(lambda: torch.where(take_g, g[None],
                                                          wn)))
            if (n, leaf) == smoke.MAIN_SHAPE:
                eq4 = dict(shape=[n, *leaf], unfused=ms(
                    lambda: aggregation.finish_masked_mean(
                        *agg_ops.masked_weighted_sum(wn, mask, wts), g,
                        dt)), mean=row["sparse_agg_mean"])
            rows.append(row)
        gs = [randn(*leaf) for leaf in smoke.MLP_LEAVES]
        ls = [randn(N, *leaf) for leaf in smoke.MLP_LEAVES]
        mks = [(torch.rand((N,) + (1,) * (len(leaf) - 1) + leaf[-1:],
                           generator=gen, device="cuda") > 0.5).float()
               for leaf in smoke.MLP_LEAVES]
        singles = [(lambda g=g, l=l, m=m: merge_ops.masked_merge(g, l, m))
                   for g, l, m in zip(gs, ls, mks)]

        def burst():
            for fn in singles:
                fn()
        eq5 = dict(leaves=len(gs),
                   per_leaf_sum=sum(ms(fn) for fn in singles),
                   per_leaf_burst=ms(burst),
                   grouped=ms(lambda: merge_ops.masked_merge_many(
                       gs, ls, mks)) if has_many else None)
        return rows, eq4, eq5

    sweep()                  # brings the card to its clocks; not kept
    kern_rows, eq4, eq5 = sweep()
    for row in kern_rows:
        print(json.dumps(row), file=sys.stderr, flush=True)

    rng = np.random.default_rng(0)
    gp = init_cnn_spec(MLP_SPEC, seed=1, device="cpu")
    old = stack_pytrees([tree.tree_map(
        lambda x: x + torch.from_numpy(
            rng.normal(0, 0.05, x.shape).astype(np.float32)), gp)
        for _ in range(N)])
    new = tree.tree_map(lambda x: x + torch.from_numpy(
        rng.normal(0, 0.02, x.shape).astype(np.float32)), old)
    on_card = lambda t: tree.tree_map(lambda x: x.cuda(), t)  # noqa: E731
    rates = torch.from_numpy(rng.uniform(0.0, 0.8, N).astype(np.float32))
    weights = torch.from_numpy(
        rng.integers(100, 1000, N).astype(np.float32))
    old, new, gp = on_card(old), on_card(new), on_card(gp)
    rates, weights = rates.cuda(), weights.cuda()
    engine = BatchedRoundEngine()
    steps = 3 + 2 * STEP_REPS

    def step_record(step):
        kernels.reset_launch_counts()
        span_ms, step_ms, ops = _step_times(step)
        return dict(clients=N, step_ms=step_ms, step_span_ms=span_ms,
                    device_ops=ops, launches_per_step={
                        k: v / steps
                        for k, v in kernels.launch_counts().items()})

    res = dict(card=card, src=str(src), build_s=build_s, kernels=kern_rows,
               eq4_fc0=eq4, eq5_mlp=eq5,
               engine_step=step_record(lambda: engine.step(
                   old, new, gp, rates, weights, full_round=False)))
    try:                  # the wire formats (absent from older packages)
        from repro_torch import prng
        from repro_torch.comm import CommConfig
        from repro_torch.core.selection import SelectionConfig
        comm = CommConfig(codec="auto", qbits=8)
    except (ImportError, NotImplementedError):
        comm = None
    if comm is not None:
        rk = prng.split(prng.PRNGKey(0))[1]
        for key, scheme in (("engine_step_auto8", "feddd"),
                            ("engine_step_auto8_random", "random")):
            eng = BatchedRoundEngine(SelectionConfig(scheme), comm)
            res[key] = step_record(lambda: eng.step(
                old, new, gp, rates, weights, rk, full_round=False))
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
