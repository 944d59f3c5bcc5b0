"""Device milliseconds a round of the kernels launched inside the
program's ``local_train`` range (local SGD)."""


def read(run):
    if run.trace is None or "local_train" not in run.trace.ranges:
        return None
    kernels = run.trace.kernels_launched_in("local_train")
    return 1e3 * run.trace.kernel_seconds(kernels) / run.trace.rounds
