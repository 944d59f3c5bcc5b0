"""Local training one client a call: ``local_epochs`` epochs of in-order
minibatch SGD (whole batches; the remainder of a shard is not a step)
with the client's own spec, ``apply_spec`` and the port's cross-entropy
under ``torch.func.grad_and_value``: the arithmetic of
``trainers/fused.py``'s ``client_epochs``, without the vmap.  The server
runs it as ``FedDDServer.run(local_train_fn=...)``; on a ragged fleet
that is the grouped engine, whose ``train_grouped`` calls it member by
member."""

import torch


def build(cfg, traffic, inputs):
    """The trainer argument of ``FedDDServer.run``."""
    from repro_torch import tree
    from repro_torch.fl import models

    # float32 without TF32, deterministic convolutions, as the port's
    # own trainers set them
    models._full_fp32()
    x, y = inputs.x, inputs.y
    specs = [cfg["specs"][j] for j in inputs.client_spec]
    batch, lr, epochs = traffic["batch"], traffic["lr"], traffic[
        "local_epochs"]
    steps = x.shape[1] // batch
    denom = torch.full((), float(steps * epochs), device=x.device)

    def local_train_fn(p, idx, key):
        del key                      # in-order minibatches draw nothing
        spec, xs, ys = specs[idx], x[idx], y[idx]

        def loss(q, xb, yb):
            return models._ce(models.apply_spec(q, spec, xb), yb)

        total = 0.0
        for _ in range(epochs):
            for s in range(steps):
                g, l = torch.func.grad_and_value(loss)(
                    p, xs[s * batch:(s + 1) * batch],
                    ys[s * batch:(s + 1) * batch])
                p = tree.tree_map(lambda w, gw: w - lr * gw, p, g)
                total = total + l
        return p, total / denom

    return {"local_train_fn": local_train_fn}
