"""How ``correct`` is decided: the program's checked rounds held against
the reference, from the same inputs.

FedDD's Eq. (20) divides each trained weight's change by its old value,
so the scores, and the top-k masks built on them, react sharply to
round-off: two float32 runs of the same rounds keep different channels
within a few rounds (a 1e-7 nudge of the starting weights flips hundreds
of mask entries by round 4).  So the reference follows the program at
two points where its state is exactly known:

* from the seed, round 1, in which every client uploads every channel
  (D = 0): local SGD, Eq. (4), and the LP's rates for round 2;
* from the program's own state, round h + 1, the round after the first
  full broadcast: every client starts from the program's global model of
  round h cut to its widths (Eq. (6)), and uploads at the rates the
  program allocated for it; local SGD, Eq. (20)/(21) scores, the top-k
  masks, Eq. (4) and Eq. (5) then run in both from the same state.

The numbers (each passes at ``value <= limit``; the limits of a cell are
in ``perfbench/limits/<cell>.json``):

* ``r1_loss`` / ``rh1_loss`` (round 1 / round h + 1): the round's mean
  client loss, the gap relative to the reference's;
* ``r1_update`` / ``rh1_update``: the round's change of the global
  model, per leaf the gap between the program's norm of the change and
  the reference's, over the larger of that leaf's reference norm and the
  median leaf's; the worst leaf;
* ``rh1_clients``: the same for the clients' models (each leaf stacked
  over the clients that hold it with one shape);
* ``rh1_local``: local SGD alone, client by client: each client's leaves
  at the channels the reference's masks keep out of the upload (there a
  client holds its own trained values), the gap as above against the
  larger of that leaf's reference norm and the fleet's median one; the
  median over every client and leaf.  Ten steps of SGD turn round-off into discrete events (an
  activation crossing a ReLU's kink, a pooling window's maximum changing
  hands) that move a round's result by 1e-4 to 1e-3 of its change, in
  float32 as in TF32, and a mask that flips moves the global channel
  every uploader takes; each event touches few clients, so the median
  client's own channels show the round-off of the arithmetic itself,
  which TF32 makes several times larger;
* ``r1_rates``: the largest gap of a rate the LP allocated for round 2;
* ``rh1_uploaded``: the gap of the round's uploaded share of the bytes.

Leaves whose reference change is under a thousandth of the median
leaf's are left out of a change (they move by round-off alone).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def _flat(params: Dict) -> Dict[str, torch.Tensor]:
    return {f"{n}.{k}": params[n][k].detach().to("cpu", torch.float64)
            for n in sorted(params) for k in sorted(params[n])}


def _stack(models: Sequence[Dict]) -> Dict[str, torch.Tensor]:
    """Each leaf of the fleet's models, stacked over the models."""
    flats = [_flat(m) for m in models]
    return {k: torch.cat([f[k].reshape(-1) for f in flats])
            for k in flats[0]}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             start: Dict[str, torch.Tensor]) -> float:
    """Worst leaf of |norm(prog - start) - norm(ref - start)| over
    max(norm(ref - start), the median leaf's), leaves the reference
    (almost) does not move left out."""
    ref_n = {k: float(torch.linalg.vector_norm(ref[k] - start[k]))
             for k in ref}
    med = float(np.median(list(ref_n.values())))
    worst = 0.0
    for k, rn in ref_n.items():
        if rn < 1e-3 * med:
            continue
        pn = float(torch.linalg.vector_norm(prog[k] - start[k]))
        worst = max(worst, abs(pn - rn) / max(rn, med))
    return worst


def local_median(prog, clients, start, masks) -> float:
    """Median over clients and leaves of each client's leaf gap at the
    channels its reference mask keeps home, against the larger of that
    leaf's reference norm and the median one over the fleet."""
    pairs = []                          # (program norm, reference norm)
    for p, r, s, m in zip(prog, clients, start, masks):
        fp, fr, fs = _flat(p), _flat(r), _flat(s)
        for (n, k), mk in m.items():
            home = (mk == 0).cpu()
            key = f"{n}.{k}"
            if home.any():
                pairs.append(tuple(float(torch.linalg.vector_norm(
                    (x[key] - fs[key])[..., home])) for x in (fp, fr)))
    if not pairs:
        return 0.0
    med = float(np.median([rn for _, rn in pairs]))
    gaps = [abs(pn - rn) / max(rn, med) for pn, rn in pairs
            if rn >= 1e-3 * med and med > 0]
    return float(np.median(gaps)) if gaps else 0.0


def cut_to(params: Dict, like: Dict) -> Dict:
    """``params`` cut to the leaf shapes of the model ``like``: the
    leading block of every axis (Eq. (6)'s sub-model at its widths); a
    leaf of the same shape is the whole tensor."""
    return {n: {k: params[n][k][tuple(slice(0, s) for s in t.shape)]
                for k, t in lay.items()} for n, lay in like.items()}


def numbers(prog, first, after, start_global: Dict) -> Dict[str, float]:
    """``prog``: the program's checked rounds (``reference.feddd.Rounds``);
    ``first``: the reference's round 1 from the seed (``Rounds``);
    ``after``: its round t = len(prog.mean_loss) from the program's global
    model of round t - 1 (``round_from``'s clients, global, loss,
    uploaded share, masks), which every client starts round t from, cut
    to the leaf shapes of its own model."""
    t = len(prog.mean_loss)
    clients, glob, loss, uploaded, masks = after
    start = [cut_to(prog.globals[t - 2], c) for c in clients]
    out = {
        "r1_loss": abs(prog.mean_loss[0] - first.mean_loss[0])
        / abs(first.mean_loss[0]),
        "r1_update": leaf_gap(_flat(prog.globals[0]),
                              _flat(first.globals[0]), _flat(start_global)),
        "r1_rates": float(np.max(np.abs(np.asarray(prog.rates[0])
                                        - first.rates[0]))),
        "rh1_loss": abs(prog.mean_loss[t - 1] - loss) / abs(loss),
        "rh1_update": leaf_gap(_flat(prog.globals[t - 1]), _flat(glob),
                                 _flat(prog.globals[t - 2])),
        "rh1_clients": leaf_gap(_stack(prog.clients_last), _stack(clients),
                                _stack(start)),
        "rh1_local": local_median(prog.clients_last, clients, start, masks),
        "rh1_uploaded": abs(prog.uploaded[t - 1] - uploaded),
    }
    return {k: (float(v) if np.isfinite(v) else float("inf"))
            for k, v in out.items()}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(values[k] <= limits[k] for k in limits)
