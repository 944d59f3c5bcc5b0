"""Eq. (5) client update (``kernels/masked_merge``), in rounds with
``t mod h != 0``: each client's trained leaf and (C,) mask read once and
its merged leaf written once, the global leaf read once; every leaf."""

from perfbench.roofline import F32, elements, share

KERNELS = ("masked_merge_kernel",)


def round_bytes(run) -> float:
    return sum((run.clients * (2 * elements(shape) + shape[-1])
                + elements(shape)) * F32
               for lay in run.leaves().values() for shape in lay.values())


def read(run):
    if run.trace is None:
        return None
    return share(run, KERNELS,
                 round_bytes(run) * run.partial_traced_rounds())
