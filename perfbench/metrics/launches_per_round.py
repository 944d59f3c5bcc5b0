"""CUDA kernels launched in the traced window, per round."""


def read(run):
    if run.trace is None:
        return None
    return len(run.trace.kernels_in_window()) / run.trace.rounds
