"""A homogeneous fleet: every client holds the configuration's global
spec and starts from the global model (the program's batched engine)."""

from perfbench.inputs import make_weights


def make(cfg, traffic, gen, device):
    """-> (each client's spec index, the global model, each client's
    starting model: here the global model itself)."""
    j = cfg["global_spec"]
    glob = make_weights([cfg["specs"][j]], gen, device)[0]
    n = traffic["clients"]
    return [j] * n, glob, [glob] * n
