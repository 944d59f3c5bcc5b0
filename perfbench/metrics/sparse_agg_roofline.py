"""Eq. (4) aggregation (``kernels/sparse_agg``): each client's upload
and its (C,) channel mask read once, the (N,) weights read once, the
global leaf written once; every leaf, every round."""

from perfbench.roofline import F32, elements, share

KERNELS = ("sparse_agg_kernel",)


def round_bytes(run) -> float:
    n = run.clients
    return sum((n * (elements(shape) + shape[-1]) + n + elements(shape))
               * F32 for lay in run.leaves().values()
               for shape in lay.values())


def read(run):
    if run.trace is None:
        return None
    return share(run, KERNELS, round_bytes(run) * run.trace.rounds)
