"""Eq. (20)/(21) channel scoring (``kernels/importance``): each client's
leaf before and after training read once and its (C,) float32 scores
written once; every leaf of every client, every round."""

from perfbench.roofline import F32, elements, share

KERNELS = ("importance_kernel",)


def round_bytes(run) -> float:
    return sum(run.clients * (2 * elements(shape) + shape[-1]) * F32
               for lay in run.leaves().values() for shape in lay.values())


def read(run):
    if run.trace is None:
        return None
    return share(run, KERNELS, round_bytes(run) * run.trace.rounds)
