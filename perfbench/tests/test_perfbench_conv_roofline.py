"""``conv_roofline`` on synthetic traces: the least time of the cell's
convolution passes, counted by hand, over the union of the named
kernels' device time; nothing where the program has no such kernel."""

import json
from pathlib import Path

import pytest

from perfbench import harness, lookup, tracing

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "perfbench/configs/cnn2-cifar10.json").read_text())
TRAFFIC = json.loads((ROOT / "perfbench/traffic/c100.fused.json")
                     .read_text())
PEAKS = {"fp32_flops": 67e12, "hbm_bytes_s": 3.35e12}


def _least_step_s():
    """CNN2 at batch 50, counted by hand: inside a 3x3 SAME pass over a
    side of s, 3s - 2 (row, tap) pairs hold; per conv (C, O, side) the
    FLOPs and the bytes of x, W and y; two passes of the first conv,
    three of the others."""
    total = 0.0
    for i, (c, o, s) in enumerate([(3, 16, 32), (16, 32, 16), (32, 64, 8)]):
        flops = 2 * 50 * (3 * s - 2) ** 2 * c * o
        nbytes = 4 * (50 * c * s * s + 9 * c * o + 50 * o * s * s)
        total += (2 if i == 0 else 3) * max(flops / 67e12, nbytes / 3.35e12)
    return total


def _run(kernels, rounds=2):
    """A traced run whose kernels are (name, start us, end us)."""
    trace = tracing.Trace(
        window=(0.0, 1e9), kernels=[(n, s, e, i) for i, (n, s, e)
                                    in enumerate(kernels)],
        device_ops=[(n, s, e) for n, s, e in kernels],
        launch_ts={i: s for i, (_, s, _) in enumerate(kernels)},
        ranges={tracing.WINDOW: [(0.0, 1e9)]}, rounds=rounds)
    return harness.RunData(cfg=CFG, traffic=TRAFFIC,
                           client_spec=[0] * TRAFFIC["clients"], setup_s=1.0,
                           round_s=[0.1] * 5, window_s=0.5,
                           flops_per_round=1, peaks=PEAKS, trace=trace)


def test_least_time_of_a_cnn2_round():
    metric = lookup.module("metrics", "conv_roofline")
    want = 100 * 10 * _least_step_s()        # clients x steps
    assert metric.round_seconds(_run([])) == pytest.approx(want, rel=1e-12)
    assert 0.0113 < want < 0.0118            # 11.6 ms at the peaks


def test_share_is_bound_over_the_union_of_named_kernels():
    """Overlapping launches count once; another kernel counts nothing."""
    least = 2 * 100 * 10 * _least_step_s()   # two traced rounds
    kernels = [
        ("void (anonymous namespace)::conv_fprop_kernel<256, 16>(Args)",
         0.0, 30_000.0),
        ("void (anonymous namespace)::conv_wgrad_kernel<32, 16>(Args)",
         20_000.0, 50_000.0),
        ("void (anonymous namespace)::conv_wgrad_reduce_kernel(float)",
         60_000.0, 70_000.0),
        ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8", 0.0,
         90_000.0)]
    got = harness.reader("conv_roofline")(_run(kernels))
    assert got == pytest.approx(100 * least / 0.060, rel=1e-12)


def test_nothing_without_the_kernels_or_a_trace():
    cudnn = [("void cudnn::genericTranspose<float>(...)", 0.0, 10.0),
             ("sm90_xmma_fprop_implicit_gemm_indexed_f32", 10.0, 20.0)]
    assert harness.reader("conv_roofline")(_run(cudnn)) is None
    run = _run([])
    run.trace = None
    assert harness.reader("conv_roofline")(run) is None
