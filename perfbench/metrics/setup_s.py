"""Process start to the first timed round: loading, making the inputs,
building the kernels where the checkout has none, and the checked first
rounds that warm up every shape."""


def read(run):
    return run.setup_s
