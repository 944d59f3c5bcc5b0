"""FedDD rounds completed in the window over the window's wall time (the
window ends in a device synchronise)."""


def read(run):
    return len(run.round_s) / run.window_s
