"""FedDD rounds written out client by client in plain PyTorch.

Round ``t`` (Algorithm 1 of the paper):

1. every client trains ``local_epochs`` epochs of minibatch SGD, the
   minibatches in order, from its own parameters, and reports its mean
   minibatch loss;
2. Eq. (20): each leaf's channel scores ``sqrt(sum |dW * W_new /
   W_old|^2)``, the division guarded at ``|W_old| < 1e-8`` (a homogeneous
   fleet covers every channel, so Eq. (21)'s coverage divides by 1);
3. each client keeps the top ``ceil(C (1 - D_n))`` channels of every
   leaf, ties toward the lower index;
4. Eq. (4): each global element is the ``m_n``-weighted mean of the
   uploads that hold it, or keeps its value where none does;
5. Eq. (5) (``t mod h != 0``): a client takes the global at its uploaded
   channels and keeps its own elsewhere; Eq. (6) (``t mod h == 0``): it
   takes the global, cut to its widths;
6. the LP (``lp.dropout_rates``) picks the next round's D_n from the
   losses.

``run_rounds`` runs rounds 1.. from the seed's inputs; ``round_from``
runs one round from a global model that every client starts from, cut
to its widths: the state after a full-broadcast round.

Parameters keep the program's layout (conv HWIO, dense (in, out), images
NHWC), since both sides start from the same tensors.  ``precision`` is
"fp32" (TF32 off: the configuration's float32) or "tf32" (the control:
TF32 for every convolution and matrix product; on a CPU, where there is
none, the operands are rounded to TF32's 10-bit mantissa).  ``fault``
plants a fault in the reference put in the program's place:
"half_batch" trains every minibatch on its first half only;
"rates_altered" moves the first client's allocated rate by 0.05.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import lp

EPS_IMPORTANCE = 1e-8
EPS_MEAN = 1e-12


@dataclasses.dataclass
class Rounds:
    """What a run of rounds produced, as ``perfbench.compare`` reads it
    from the program and from the reference alike."""
    mean_loss: List[float]           # each round's mean client loss
    rates: List[np.ndarray]          # D_n allocated after each round
    uploaded: List[float]            # kept bytes / full bytes, each round
    globals: List[Dict]              # the global model after each round
    clients_last: List[Dict]         # each client's model after the last


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10-bit mantissa), to nearest; the gradient
    passes through unchanged."""
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (rounded - t).detach()


class Model:
    """The configuration's spec as plain convolutions and products."""

    def __init__(self, spec: Sequence, precision: str, device):
        self.spec = spec
        self.emulate = precision == "tf32" and torch.device(
            device).type != "cuda"

    def _op(self, t):
        return _tf32(t) if self.emulate else t

    def __call__(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        dtype = next(iter(params.values()))["w"].dtype
        h = x.to(dtype).permute(0, 3, 1, 2)
        n_fc = sum(l[0] == "fc" for l in self.spec)
        fc_seen, i = 0, 0
        for layer in self.spec:
            if layer[0] == "pool":
                h = F.max_pool2d(h, 2)
                continue
            p = params[f"{layer[0]}{i}"]
            i += 1
            if layer[0] == "conv":
                k = layer[3]
                h = F.relu(F.conv2d(self._op(h),
                                    self._op(p["w"].permute(3, 2, 0, 1)),
                                    p["b"], padding=k // 2))
            else:
                if h.ndim > 2:      # flatten in NHWC order
                    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
                h = F.linear(self._op(h), self._op(p["w"].t()), p["b"])
                fc_seen += 1
                if fc_seen < n_fc:
                    h = F.relu(h)
        return h


def _leaves(params: Dict):
    """(name, key, tensor) in the program's flatten order: keys sorted."""
    return [(name, k, params[name][k]) for name in sorted(params)
            for k in sorted(params[name])]


def _clone(params: Dict, dtype=None) -> Dict:
    return {n: {k: t.to(dtype or t.dtype, copy=True) for k, t in lay.items()}
            for n, lay in params.items()}


def _dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "fp64" else torch.float32


def sgd_epochs(model: Model, params: Dict, x, y, *, epochs: int, batch: int,
               lr: float, fault: Optional[str]):
    """``epochs`` epochs of minibatch SGD, whole batches in order (the
    remainder of a shard is not a step) -> (params, mean minibatch
    loss)."""
    names = [(n, k) for n, k, _ in _leaves(params)]
    leaves = [params[n][k] for n, k in names]
    starts = list(range(0, x.shape[0] - batch + 1, batch)) * epochs
    total, steps = 0.0, 0
    for s in starts:
        xb, yb = x[s:s + batch], y[s:s + batch]
        if fault == "half_batch":
            xb, yb = xb[:batch // 2], yb[:batch // 2]
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        p = {}
        for (nm, k), l in zip(names, leaves):
            p.setdefault(nm, {})[k] = l
        loss = F.cross_entropy(model(p, xb), yb)
        grads = torch.autograd.grad(loss, leaves)
        leaves = [(l - lr * g).detach() for l, g in zip(leaves, grads)]
        total += float(loss.detach())
        steps += 1
    out = {}
    for (nm, k), l in zip(names, leaves):
        out.setdefault(nm, {})[k] = l
    return out, total / max(steps, 1)


def channel_scores(w_old: torch.Tensor, w_new: torch.Tensor) -> torch.Tensor:
    """Eq. (20) per channel (the last axis)."""
    dw = w_new - w_old
    denom = torch.where(w_old.abs() < EPS_IMPORTANCE,
                        torch.where(w_old < 0, -EPS_IMPORTANCE,
                                    EPS_IMPORTANCE), w_old)
    imp = (dw * w_new / denom).reshape(-1, w_new.shape[-1])
    return torch.sqrt((imp * imp).sum(0))


def keep_count(channels: int, rate: float) -> int:
    """ceil(C (1 - D)) in float32, within [0, C]."""
    k = np.ceil(np.float32(channels) * (np.float32(1.0) - np.float32(rate)))
    return int(np.clip(k, 0, channels))


def top_mask(score: torch.Tensor, keep: int) -> torch.Tensor:
    order = torch.sort(score, descending=True, stable=True).indices
    mask = torch.zeros_like(score)
    mask[order[:keep]] = 1.0
    return mask


def _block(shape) -> tuple:
    return tuple(slice(0, s) for s in shape)


@dataclasses.dataclass
class Fleet:
    """What every round reads: the models, each client's spec, data and
    Eq. (4) weight, the telemetry."""
    traffic: Dict
    models: List[Model]
    client_spec: List[int]
    x: torch.Tensor
    y: torch.Tensor
    weights: torch.Tensor
    telemetry: Dict
    global_bytes: int
    fault: Optional[str]


def fleet(cfg: Dict, traffic: Dict, inputs, precision: str = "fp32",
          fault: Optional[str] = None) -> Fleet:
    dev = inputs.x.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
        torch.backends.cudnn.allow_tf32 = precision == "tf32"
        torch.backends.cudnn.deterministic = True
    tel = inputs.telemetry
    return Fleet(traffic, [Model(s, precision, dev) for s in cfg["specs"]],
                 list(inputs.client_spec), inputs.x, inputs.y,
                 torch.as_tensor(tel["num_samples"], dtype=torch.float32,
                                 device=dev), tel,
                 sum(t.numel() * 4 for _, _, t in
                     _leaves(inputs.global_params)), fault)


def one_round(fl: Fleet, clients: List[Dict], glob: Dict, rates, t: int):
    """Round ``t`` from the clients' and the global model's state and the
    rates D_n it uploads at -> (clients, global, losses, uploaded share,
    each client's {(layer, key): channel mask})."""
    traffic, n = fl.traffic, len(clients)
    trained, losses = [], np.zeros(n)
    for i in range(n):
        p, losses[i] = sgd_epochs(
            fl.models[fl.client_spec[i]], clients[i], fl.x[i], fl.y[i],
            epochs=traffic["local_epochs"], batch=traffic["batch"],
            lr=traffic["lr"], fault=fl.fault)
        trained.append(p)
    num = {(nm, k): torch.zeros_like(g) for nm, k, g in _leaves(glob)}
    den = {leaf: torch.zeros_like(v) for leaf, v in num.items()}
    masks, uploaded = [], 0.0
    for i in range(n):
        m_i, kept, size = {}, np.float32(0), np.float32(0)
        for nm, k, w in _leaves(trained[i]):
            c = w.shape[-1]
            m = top_mask(channel_scores(clients[i][nm][k], w),
                         keep_count(c, rates[i]))
            m_i[(nm, k)] = m
            kept += np.float32(float(m.sum()) * (w.numel() // c))
            size += np.float32(w.numel())
            blk = _block(w.shape)
            num[(nm, k)][blk] += w * m * fl.weights[i]
            den[(nm, k)][blk] += (m * fl.weights[i]).expand(w.shape)
        masks.append(m_i)
        uploaded += float(kept / size) * fl.telemetry["model_bytes"][i]
    new_glob = {nm: dict(lay) for nm, lay in glob.items()}
    for (nm, k), v in num.items():
        d = den[(nm, k)]
        new_glob[nm][k] = torch.where(d > EPS_MEAN,
                                      v / torch.clamp(d, min=EPS_MEAN),
                                      glob[nm][k])
    new_clients = []
    for i in range(n):
        new = {}
        for nm, k, w in _leaves(trained[i]):
            g = new_glob[nm][k][_block(w.shape)]
            m = masks[i][(nm, k)]
            new.setdefault(nm, {})[k] = (g.clone() if t % traffic["h"] == 0
                                         else g * m + w * (1.0 - m))
        new_clients.append(new)
    return (new_clients, new_glob, losses,
            uploaded / float(np.sum(fl.telemetry["model_bytes"])), masks)


def next_rates(fl: Fleet, losses: np.ndarray) -> np.ndarray:
    return lp.dropout_rates(
        fl.telemetry, np.maximum(losses, 1e-6),
        a_server=fl.traffic["a_server"], d_max=fl.traffic["d_max"],
        delta=1.0, global_model_bytes=fl.global_bytes)


def run_rounds(cfg: Dict, traffic: Dict, inputs, rounds: int, *,
               precision: str = "fp32", fault: Optional[str] = None
               ) -> Rounds:
    """Rounds 1 .. ``rounds`` from the seed's inputs."""
    fl = fleet(cfg, traffic, inputs, precision, fault)
    clients = [_clone(p, _dtype(precision)) for p in inputs.client_params]
    glob = _clone(inputs.global_params, _dtype(precision))
    rates = np.zeros(traffic["clients"])
    out = Rounds([], [], [], [], [])
    for t in range(1, rounds + 1):
        clients, glob, losses, up, _ = one_round(fl, clients, glob, rates,
                                                 t)
        rates = next_rates(fl, losses)
        if fault == "rates_altered":
            rates[0] += -0.05 if rates[0] >= 0.05 else 0.05
        out.mean_loss.append(float(np.mean(losses)))
        out.rates.append(rates.copy())
        out.uploaded.append(up)
        out.globals.append(_clone(glob))
    out.clients_last = clients
    return out


def round_from(cfg: Dict, traffic: Dict, inputs, t: int, glob: Dict,
               rates, *, precision: str = "fp32"):
    """Round ``t`` (one after a full-broadcast round) from a global model:
    every client starts from it, cut to its widths (Eq. (6)), and uploads
    at ``rates`` -> (clients, global, mean loss, uploaded share, masks)."""
    fl = fleet(cfg, traffic, inputs, precision)
    dev = inputs.x.device
    glob = {nm: {k: v.to(dev, _dtype(precision)) for k, v in lay.items()}
            for nm, lay in glob.items()}
    clients = [{nm: {k: glob[nm][k][_block(v.shape)].clone()
                     for k, v in lay.items()} for nm, lay in p.items()}
               for p in inputs.client_params]
    clients, glob, losses, up, masks = one_round(fl, clients, glob,
                                                 np.asarray(rates), t)
    return clients, glob, float(np.mean(losses)), up, masks
