"""The 90th percentile of round time in the traced run, over the
window's rounds that the profiler did not record, nor the round after
them, which pays for stopping it; a round runs from the end of the one
before (or the window's start) to the moment its telemetry reached the
host and the LP ran.  The host's enqueue paces these rounds, so their
tail follows the host's speed from run to run; it is read here, per
layer, beside ``rounds_per_s``."""

import numpy as np


def read(run):
    if run.trace is None or not run.traced_round_ids:
        return None
    skip = set(run.traced_round_ids) | {max(run.traced_round_ids) + 1}
    rounds = [s for k, s in enumerate(run.round_s, 1) if k not in skip]
    return float(np.percentile(rounds, 90)) if rounds else None
