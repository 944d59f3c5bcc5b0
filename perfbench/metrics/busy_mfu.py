"""The traced rounds' model FLOPs of local training (``perfbench.flops``)
over the seconds in which the device ran an operation (the union of
kernels, copies and sets in the trace), as a share of the card's float32
peak: the whole round's device work against the peak, which bounds
every kernel's roofline share."""


def read(run):
    if run.trace is None or run.trace.busy_s() <= 0:
        return None
    flops = run.trace.rounds * run.flops_per_round
    return 100.0 * flops / run.trace.busy_s() / run.peaks["fp32_flops"]
