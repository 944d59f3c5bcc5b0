"""A ragged fleet: client ``i`` holds spec ``i mod len(specs)`` and
starts from weights of its own (as the port's ``heterogeneous.setup``
gives each client its own draw); the global model is the global spec's,
drawn after them from the same generator.  The specs are sub-models of
the global one, cut in width (the leading channels of each layer)."""

from perfbench.inputs import make_weights


def make(cfg, traffic, gen, device):
    """-> (each client's spec index, the global model, each client's
    starting model)."""
    specs = cfg["specs"]
    client_spec = [i % len(specs) for i in range(traffic["clients"])]
    clients = make_weights([specs[j] for j in client_spec], gen, device)
    glob = make_weights([specs[cfg["global_spec"]]], gen, device)[0]
    return client_spec, glob, clients
