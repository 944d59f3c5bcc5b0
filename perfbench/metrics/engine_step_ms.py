"""Device milliseconds a round of the kernels launched inside the
program's ``engine_step`` range (masks, Eq. (4), Eq. (5)/(6))."""


def read(run):
    if run.trace is None or "engine_step" not in run.trace.ranges:
        return None
    kernels = run.trace.kernels_launched_in("engine_step")
    return 1e3 * run.trace.kernel_seconds(kernels) / run.trace.rounds
