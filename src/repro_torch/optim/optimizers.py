"""Optimizers as plain functions on tensor pytrees: the JAX package's
``repro.optim.optimizers`` (no ``torch.optim``).

    opt = adamw(lr=1e-3, weight_decay=0.01)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

States have the JAX package's layout, so they cross leaf for leaf
(:func:`repro_torch.convert.train_state_from_jax`): ``{"step"}`` plus
``"mu"`` (sgd with momentum), ``"m"`` and ``"v"`` (adam), or ``"v"``
holding ``{"vr", "vc"}`` or ``{"v"}`` per leaf (adafactor).  ``step`` is
a 0-d int32 tensor; moments are float32 whatever the parameter dtype.

``update`` writes the moments IN PLACE and returns the state that holds
them: the state passed in is consumed, as the JAX drivers donate theirs
to ``jit``, so an AdamW step needs the moments once (8 bytes a
parameter), not twice.  The arithmetic is the JAX package's, operation
for operation.

On an ``LMMesh`` (:func:`update_placed`) grads, state and params are
``models.sharding.Placed`` trees.  sgd and adam are elementwise: every
device updates its own blocks.  Adafactor's row and column means of
``g**2`` run over the whole leaf: the blocks' partial sums combine over
the mesh axes that cut the leaf's last two dimensions, every device
keeps ``vr``/``vc`` whole (the JAX package's specs replicate them) and
updates its block from its slice of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.models import sharding

Params = Any
Grads = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Grads, Any, Optional[Params]], Tuple[Any, Any]]
    # the update on placed trees, where it is not elementwise
    placed: Optional[Callable] = None


def update_placed(opt: Optimizer, grads: sharding.Placed,
                  state: sharding.Placed,
                  params: Optional[sharding.Placed] = None):
    """``opt.update`` on a mesh: (updates, state), each a ``Placed`` like
    ``grads`` and ``state``.  The moments are written in place, as
    ``update`` writes them."""
    if opt.placed is not None:
        return opt.placed(grads, state, params)
    ps = params.shards if params is not None else (None,) * len(
        grads.shards)
    outs = [opt.update(g, s, p) for g, s, p in zip(grads.shards,
                                                   state.shards, ps)]
    return (sharding.Placed(grads.mesh, grads.specs,
                            tuple(u for u, _ in outs)),
            sharding.Placed(state.mesh, state.specs,
                            tuple(s for _, s in outs)))


def apply_updates(params: Params, updates: Any) -> Params:
    """``p + u`` in float32, cast back to the parameter's dtype."""
    with torch.no_grad():
        return tree.tree_map(lambda p, u: (p.float() + u).to(p.dtype),
                             params, updates)


def _zeros32(params):
    return tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)


def _step0(params) -> torch.Tensor:
    dev = tree.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# --------------------------------------------------------------- sgd -------

def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params), "mu": _zeros32(params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        step = state["step"] + 1
        if momentum == 0.0:
            return (tree.tree_map(lambda g: -lr * g.float(), grads),
                    {"step": step})

        def _mu(m, g):
            return m.mul_(momentum).add_(g.float())

        mu = tree.tree_map(_mu, state["mu"], grads)
        return tree.tree_map(lambda m: -lr * m, mu), {"step": step, "mu": mu}

    return Optimizer(init, update)


# --------------------------------------------------------------- adam ------

def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": _step0(params), "m": _zeros32(params),
                "v": _zeros32(params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        t = step.float()
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        decay = bool(weight_decay) and params is not None
        g_l, td = tree.flatten(grads)
        m_l, v_l = tree.leaves(state["m"]), tree.leaves(state["v"])
        p_l = tree.leaves(params) if decay else [None] * len(g_l)
        ups = []
        for g, m, v, p in zip(g_l, m_l, v_l, p_l):
            gf = g.float()
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * torch.square(gf))
            # -lr * (m / bc1) / (sqrt(v / bc2) + eps), two temporaries
            upd = (m / bc1).mul_(-lr)
            upd.div_((v / bc2).sqrt_().add_(eps))
            if p is not None:
                upd.sub_(p.float() * (lr * weight_decay))
            ups.append(upd)
        return tree.unflatten(td, ups), {"step": step, "m": state["m"],
                                         "v": state["v"]}

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay)


# ------------------------------------------------------------ adafactor ----

def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30
              ) -> Optimizer:
    """Factored second moments: a rank-2+ leaf keeps a row and a column
    mean of ``g**2`` over its last two axes."""

    def _s(p):
        dev = p.device
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=dev),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=dev)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32, device=dev)}

    def init(params):
        leaves, td = tree.flatten(params)
        return {"step": _step0(params),
                "v": tree.unflatten(td, [_s(p) for p in leaves])}

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        step = state["step"] + 1
        t = step.float()
        beta = 1.0 - torch.pow(t, -decay)

        def _u(g, s):
            gf = g.float()
            g2 = torch.square(gf) + eps
            if "vr" in s:
                vr = s["vr"].mul_(beta).add_((1 - beta) * g2.mean(-1))
                vc = s["vc"].mul_(beta).add_((1 - beta) * g2.mean(-2))
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1, keepdim=True)[..., None],
                                       min=eps))
                return -lr * gf / torch.sqrt(torch.clamp(denom, min=eps))
            v = s["v"].mul_(beta).add_((1 - beta) * g2)
            return -lr * gf / torch.sqrt(torch.clamp(v, min=eps))

        g_l, td = tree.flatten(grads)
        s_l = tree.flatten_up_to(td, state["v"])
        ups = tree.unflatten(td, [_u(g, s) for g, s in zip(g_l, s_l)])
        return ups, {"step": step, "v": state["v"]}

    @torch.no_grad()
    def placed(grads, state, params=None):
        del params
        mesh = grads.mesh
        dev0 = mesh.devices[0]
        specs = tree.leaves(grads.specs)
        g_dev, s_dev = [], []
        for g, st in zip(grads.shards, state.shards):
            g_l, td = tree.flatten(g)
            g_dev.append(g_l)
            s_dev.append(tree.flatten_up_to(td, st["v"]))
        steps = [st["step"] + 1 for st in state.shards]
        betas = [1.0 - torch.pow(t.float(), -decay) for t in steps]
        ups = [[] for _ in range(mesh.size)]
        for i, sp in enumerate(specs):
            gs = [g_l[i].float() for g_l in g_dev]
            g2 = [torch.square(g) + eps for g in gs]
            if "vr" in s_dev[0][i]:
                # the whole leaf's row and column means, from the blocks'
                # partial sums over the axes cutting the summed dimension
                rows = sharding.sum_blocks([t.sum(-1) for t in g2], sp[:-1],
                                           sp[-1], mesh, dev0)
                cols = sharding.sum_blocks([t.sum(-2) for t in g2],
                                           sp[:-2] + sp[-1:], sp[-2], mesh,
                                           dev0)
                rows = rows / (g2[0].shape[-1]
                               * sharding.block_count(sp[-1], mesh))
                cols = cols / (g2[0].shape[-2]
                               * sharding.block_count(sp[-2], mesh))
            else:
                whole = sharding.sum_blocks(g2, sp, None, mesh, dev0)
            for k, (s, beta) in enumerate(zip((sl[i] for sl in s_dev),
                                              betas)):
                dev = mesh.devices[k]
                if "vr" in s:
                    vr = s["vr"].mul_(beta).add_((1 - beta) * rows.to(dev))
                    vc = s["vc"].mul_(beta).add_((1 - beta) * cols.to(dev))
                    rm = sharding.block(vr.mean(-1, keepdim=True),
                                        sp[:-2] + (None,), mesh, k)
                    denom = (sharding.block(vr, sp[:-1], mesh, k)[..., None]
                             * sharding.block(vc, sp[:-2] + sp[-1:], mesh,
                                              k)[..., None, :]
                             / torch.clamp(rm[..., None], min=eps))
                else:
                    v = s["v"].mul_(beta).add_((1 - beta) * whole.to(dev))
                    denom = sharding.block(v, sp, mesh, k)
                ups[k].append(-lr * gs[k] / torch.sqrt(
                    torch.clamp(denom, min=eps)))
        return (sharding.Placed(mesh, grads.specs, tuple(
                    tree.unflatten(td, u) for u in ups)),
                sharding.Placed(state.mesh, state.specs, tuple(
                    {"step": t, "v": st["v"]}
                    for t, st in zip(steps, state.shards))))

    return Optimizer(init, update, placed)
