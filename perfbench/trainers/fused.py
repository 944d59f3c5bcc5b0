"""Local training as one fused call over a homogeneous fleet: each
client runs ``local_epochs`` epochs of in-order minibatch SGD (whole
batches; the remainder of a shard is not a step), written as a user of
the port writes it (``apply_spec`` and the port's cross-entropy under
``torch.func.grad_and_value``) and vmapped over the fleet by
``core.round_engine.make_batched_train_fn``.  The server runs it as
``FedDDServer.run(batched_train_fn=...)`` on the batched engine."""

import torch


def build(cfg, traffic, inputs):
    """The trainer argument of ``FedDDServer.run``."""
    from repro_torch import tree
    from repro_torch.core.round_engine import make_batched_train_fn
    from repro_torch.fl import models

    spec = cfg["specs"][cfg["global_spec"]]
    x, y = inputs.x, inputs.y
    batch, lr = traffic["batch"], traffic["lr"]
    steps = x.shape[1] // batch
    denom = torch.full((), float(steps * traffic["local_epochs"]),
                       device=x.device)

    def loss(p, xb, yb):
        return models._ce(models.apply_spec(p, spec, xb), yb)

    def client_epochs(p, xs, ys):
        total = 0.0
        for _ in range(traffic["local_epochs"]):
            for s in range(steps):
                g, l = torch.func.grad_and_value(loss)(
                    p, xs[s * batch:(s + 1) * batch],
                    ys[s * batch:(s + 1) * batch])
                p = tree.tree_map(lambda w, gw: w - lr * gw, p, g)
                total = total + l
        return p, total / denom

    return {"batched_train_fn": make_batched_train_fn(client_epochs,
                                                      (x, y))}
