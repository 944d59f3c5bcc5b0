"""FedDD rounds over a model-heterogeneous fleet, written out client by
client in plain PyTorch: ``feddd.py``'s round with Eq. (21).

Each client holds a sub-model of the global one, cut in width: the
leading block of every axis of each leaf (HeteroFL's layout, as the
port's ``client_params`` are).  Round ``t``:

1. every client trains as in ``feddd.py`` (in-order minibatch SGD from
   its own parameters, its own spec);
2. Eq. (20) scores each leaf's channels at the client's own widths, and
   Eq. (21) divides each score by the coverage rate CR(k): the share of
   the fleet's clients whose sub-model holds channel ``k`` of that leaf;
3. each client keeps the top ``ceil(C_n (1 - D_n))`` of its ``C_n``
   channels, ties toward the lower index;
4. Eq. (4) on the full-width canvas: each global element is the
   ``m_n``-weighted mean of the uploads that hold it, or keeps its value
   where none does;
5. Eq. (5) / Eq. (6) at the client's widths against the global model cut
   to them;
6. the frozen LP picks the next round's D_n.

Departures from the paper: a sub-model's channels are the leading ones
of each leaf (the paper prunes widths without saying which channels
stay); CR counts every client of the fleet, since every client takes
part in a FedDD round; the division of Eq. (21) applies to the channel's
score ``sqrt(sum I^2)``, which equals dividing each of its terms, as
CR(k) > 0; and the minibatches run in order (the paper shuffles), as
``feddd.py``'s do.

``Rounds``, ``run_rounds`` and ``round_from`` take the arguments of
``feddd.py``'s (``precision`` "fp32", "tf32" or "fp64"; ``fault``
"half_batch" or "rates_altered"), so the harness and ``control.py``
drive either.  On a fleet in which every client holds the global spec,
every CR is 1 and a round equals ``feddd.py``'s bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference import feddd
from perfbench.reference.feddd import Rounds  # noqa: F401 (the harness's)


def coverage_rates(client_params: Sequence[Dict], global_params: Dict
                   ) -> Dict[tuple, torch.Tensor]:
    """{(layer, key): (C,) float64 CR} over the global leaf's channels
    (the last axis): the share of clients whose leaf holds channel k."""
    n = len(client_params)
    out = {}
    for nm, k, g in feddd._leaves(global_params):
        counts = torch.zeros(g.shape[-1], dtype=torch.float64)
        for p in client_params:
            counts[:p[nm][k].shape[-1]] += 1.0
        out[(nm, k)] = counts / n
    return out


def channel_scores(w_old: torch.Tensor, w_new: torch.Tensor,
                   cr: torch.Tensor) -> torch.Tensor:
    """Eq. (21): Eq. (20)'s scores over the coverage rates of the
    client's channels (``cr`` of the global leaf, cut to its width)."""
    score = feddd.channel_scores(w_old, w_new)
    return score / cr[:score.shape[0]].to(score.device, score.dtype)


def one_round(fl: feddd.Fleet, cr: Dict[tuple, torch.Tensor],
              clients: List[Dict], glob: Dict, rates, t: int):
    """``feddd.one_round`` with the Eq. (21) scores -> (clients, global,
    losses, uploaded share, each client's {(layer, key): mask})."""
    traffic, n = fl.traffic, len(clients)
    trained, losses = [], np.zeros(n)
    for i in range(n):
        p, losses[i] = feddd.sgd_epochs(
            fl.models[fl.client_spec[i]], clients[i], fl.x[i], fl.y[i],
            epochs=traffic["local_epochs"], batch=traffic["batch"],
            lr=traffic["lr"], fault=fl.fault)
        trained.append(p)
    num = {(nm, k): torch.zeros_like(g) for nm, k, g in feddd._leaves(glob)}
    den = {leaf: torch.zeros_like(v) for leaf, v in num.items()}
    masks, uploaded = [], 0.0
    for i in range(n):
        m_i, kept, size = {}, np.float32(0), np.float32(0)
        for nm, k, w in feddd._leaves(trained[i]):
            c = w.shape[-1]
            m = feddd.top_mask(
                channel_scores(clients[i][nm][k], w, cr[(nm, k)]),
                feddd.keep_count(c, rates[i]))
            m_i[(nm, k)] = m
            kept += np.float32(float(m.sum()) * (w.numel() // c))
            size += np.float32(w.numel())
            blk = feddd._block(w.shape)
            num[(nm, k)][blk] += w * m * fl.weights[i]
            den[(nm, k)][blk] += (m * fl.weights[i]).expand(w.shape)
        masks.append(m_i)
        uploaded += float(kept / size) * fl.telemetry["model_bytes"][i]
    new_glob = {nm: dict(lay) for nm, lay in glob.items()}
    for (nm, k), v in num.items():
        d = den[(nm, k)]
        new_glob[nm][k] = torch.where(
            d > feddd.EPS_MEAN, v / torch.clamp(d, min=feddd.EPS_MEAN),
            glob[nm][k])
    new_clients = []
    for i in range(n):
        new = {}
        for nm, k, w in feddd._leaves(trained[i]):
            g = new_glob[nm][k][feddd._block(w.shape)]
            m = masks[i][(nm, k)]
            new.setdefault(nm, {})[k] = (g.clone() if t % traffic["h"] == 0
                                         else g * m + w * (1.0 - m))
        new_clients.append(new)
    return (new_clients, new_glob, losses,
            uploaded / float(np.sum(fl.telemetry["model_bytes"])), masks)


def run_rounds(cfg: Dict, traffic: Dict, inputs, rounds: int, *,
               precision: str = "fp32", fault: Optional[str] = None
               ) -> Rounds:
    """Rounds 1 .. ``rounds`` from the seed's inputs."""
    fl = feddd.fleet(cfg, traffic, inputs, precision, fault)
    cr = coverage_rates(inputs.client_params, inputs.global_params)
    dtype = feddd._dtype(precision)
    clients = [feddd._clone(p, dtype) for p in inputs.client_params]
    glob = feddd._clone(inputs.global_params, dtype)
    rates = np.zeros(traffic["clients"])
    out = Rounds([], [], [], [], [])
    for t in range(1, rounds + 1):
        clients, glob, losses, up, _ = one_round(fl, cr, clients, glob,
                                                 rates, t)
        rates = feddd.next_rates(fl, losses)
        if fault == "rates_altered":
            rates[0] += -0.05 if rates[0] >= 0.05 else 0.05
        out.mean_loss.append(float(np.mean(losses)))
        out.rates.append(rates.copy())
        out.uploaded.append(up)
        out.globals.append(feddd._clone(glob))
    out.clients_last = clients
    return out


def round_from(cfg: Dict, traffic: Dict, inputs, t: int, glob: Dict,
               rates, *, precision: str = "fp32"):
    """Round ``t`` (one after a full-broadcast round) from a global model:
    every client starts from it, cut to its widths (Eq. (6)), and uploads
    at ``rates`` -> (clients, global, mean loss, uploaded share, masks)."""
    fl = feddd.fleet(cfg, traffic, inputs, precision)
    cr = coverage_rates(inputs.client_params, inputs.global_params)
    dev, dtype = inputs.x.device, feddd._dtype(precision)
    glob = {nm: {k: v.to(dev, dtype) for k, v in lay.items()}
            for nm, lay in glob.items()}
    clients = [{nm: {k: glob[nm][k][feddd._block(v.shape)].clone()
                     for k, v in lay.items()} for nm, lay in p.items()}
               for p in inputs.client_params]
    clients, glob, losses, up, masks = one_round(fl, cr, clients, glob,
                                                 np.asarray(rates), t)
    return clients, glob, float(np.mean(losses)), up, masks
