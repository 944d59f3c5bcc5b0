"""The client-batched convolutions of local SGD (the program's
``conv_fprop_kernel``, ``conv_wgrad_kernel`` and
``conv_wgrad_reduce_kernel``) against their roofline: the least time the
card needs for the traced rounds' convolution passes over the device
time of those kernels in the traced window.

Passes, from the cell's model spec: the forward pass of every conv, the
input gradient of every conv but the first (the images take none) and
the weight gradient of every conv, for every client and sample step.
A pass's least time is the larger of its FLOPs over the float32 peak (2
a multiply-add, counting only the taps that fall inside the image) and
its bytes over the HBM bandwidth (each operand read once, its output
written once: the activation, the weights and the output or gradient,
float32).  A program without these kernels reads nothing."""

from __future__ import annotations

import re

F32 = 4
KERNELS = ("conv_fprop_kernel", "conv_wgrad_kernel",
           "conv_wgrad_reduce_kernel")
_PATTERN = re.compile(r"\b(" + "|".join(KERNELS) + r")\b")


def valid_taps(size: int, k: int) -> int:
    """(output position, tap) pairs of a SAME k-tap pass over ``size``
    positions whose input lies inside."""
    p = (k - 1) // 2
    return sum(size - abs(t - p) for t in range(k) if abs(t - p) < size)


def step_seconds(spec, image, batch: int, peaks) -> float:
    """Least seconds of one client's convolution passes in a sample step
    of ``batch`` images."""
    h, w, _ = image
    total, first = 0.0, True
    for layer in spec:
        if layer[0] == "conv":
            _, cin, cout, k = layer
            flops = 2.0 * batch * valid_taps(h, k) * valid_taps(w, k) \
                * cin * cout
            nbytes = F32 * (batch * (cin + cout) * h * w + cout * cin * k * k)
            passes = 2 if first else 3
            total += passes * max(flops / peaks["fp32_flops"],
                                  nbytes / peaks["hbm_bytes_s"])
            first = False
        elif layer[0] == "pool":
            h, w = h // 2, w // 2
    return total


def round_seconds(run) -> float:
    """Least seconds of a round's convolution passes over the fleet."""
    t = run.traffic
    steps = t["local_epochs"] * ((t["samples_per_client"] - t["batch"])
                                 // t["batch"] + 1)
    return sum(steps * step_seconds(run.cfg["specs"][j], run.cfg["image"],
                                    t["batch"], run.peaks)
               for j in run.client_spec)


def read(run):
    if run.trace is None:
        return None
    kernels = [k for k in run.trace.kernels_in_window()
               if _PATTERN.search(k[0])]
    seconds = run.trace.kernel_seconds(kernels)
    if not kernels or seconds <= 0:
        return None
    return 100.0 * round_seconds(run) * run.trace.rounds / seconds
