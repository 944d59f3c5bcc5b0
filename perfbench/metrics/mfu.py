"""Local training's model FLOPs in the window (``perfbench.flops``: 3x
the forward FLOPs of every sample step) over the window's time, as a
share of the card's float32 peak (the models train in float32 with TF32
off)."""


def read(run):
    flops = len(run.round_s) * run.flops_per_round
    return 100.0 * flops / run.window_s / run.peaks["fp32_flops"]
