"""The inputs of one run, made from ``--seed``: images and labels, the
clients' shards, every model's starting weights and the clients'
telemetry.  Both the program and the reference are handed these same
tensors; neither makes its own.

Images are synthetic CIFAR-10 (the configuration's ``data``): each class
a mixture of Gaussians in a latent space, projected through a random
linear map and ``tanh`` into ``image`` pixels, the distribution of the
port's ``data/synthetic.py``, drawn here on the device in a few large
calls.  Every seed gives every client the same number of samples, so the
work of a round does not depend on the seed; the seed picks the labels,
the pixels, the weights and the telemetry.

The traffic names its labels (``perfbench/labels/<labels>.py``, whose
``draw`` makes them) and its fleet (``perfbench/fleets/<fleet>.py``,
whose ``make`` gives each client its spec and its starting model).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench import lookup


@dataclasses.dataclass
class Inputs:
    x: torch.Tensor                  # (N, S, H, W, C) float32 images
    y: torch.Tensor                  # (N, S) int64 labels
    global_params: Dict              # the starting global model
    client_params: List[Dict]        # each client's starting model
    client_spec: List[int]           # index into the config's specs
    telemetry: Dict[str, np.ndarray]  # ClientTelemetry's fields
    protocol_seed: int               # the FedDD key chain's seed


def sub_seeds(seed: int, count: int) -> List[int]:
    """``count`` independent 63-bit seeds from one run seed of any size."""
    state = np.random.SeedSequence(int(seed)).generate_state(count, np.uint64)
    return [int(s) >> 1 for s in state]


def leaf_shapes(spec: Sequence) -> Dict[str, Dict[str, tuple]]:
    """{layer: {"w": shape, "b": shape}} of a spec, named as the port names
    them: ``conv<i>`` / ``fc<i>`` with ``i`` counting the layers that hold
    weights; conv weights HWIO, dense (in, out)."""
    shapes = {}
    for i, layer in enumerate(l for l in spec if l[0] != "pool"):
        if layer[0] == "conv":
            _, cin, cout, k = layer
            shapes[f"conv{i}"] = {"w": (k, k, cin, cout), "b": (cout,)}
        else:
            _, din, dout = layer
            shapes[f"fc{i}"] = {"w": (din, dout), "b": (dout,)}
    return shapes


def _fan_in(shape: tuple) -> int:
    return math.prod(shape[:-1])


def make_weights(specs: Sequence, gen: torch.Generator,
                 device: torch.device) -> List[Dict]:
    """One model per spec: every weight of every model from one normal
    draw, each scaled by 1/sqrt(fan-in); biases zero."""
    shapes = [leaf_shapes(s) for s in specs]
    total = sum(math.prod(lay["w"]) for sh in shapes for lay in sh.values())
    flat = torch.randn(total, generator=gen, device=device)
    models, at = [], 0
    for sh in shapes:
        model = {}
        for name, lay in sh.items():
            size = math.prod(lay["w"])
            w = flat[at:at + size].view(lay["w"]) / math.sqrt(
                _fan_in(lay["w"]))
            at += size
            model[name] = {"w": w.contiguous(),
                           "b": torch.zeros(lay["b"], device=device)}
        models.append(model)
    return models


def make_images(cfg: Dict, y: torch.Tensor, gen: torch.Generator
                ) -> torch.Tensor:
    """Synthetic images for labels ``y`` (any shape) -> y.shape + image."""
    d = cfg["data"]
    h, w, c = cfg["image"]
    lat, modes = d["latent_dim"], d["modes_per_class"]
    dev = y.device
    proj = torch.randn((lat, h * w * c), generator=gen, device=dev) / \
        math.sqrt(lat)
    centers = torch.randn((cfg["classes"], modes, lat), generator=gen,
                          device=dev) * d["class_sep"]
    flat = y.reshape(-1)
    mode = torch.randint(modes, flat.shape, generator=gen, device=dev)
    z = centers[flat, mode] + d["noise"] * torch.randn(
        (flat.numel(), lat), generator=gen, device=dev)
    return torch.tanh(z @ proj).reshape(*y.shape, h, w, c)


def label_coverage(y: torch.Tensor, classes: int) -> np.ndarray:
    """Eq. (13)'s data term of each client, sum_c min(C * dis_c, 1)."""
    counts = torch.nn.functional.one_hot(y, classes).sum(1).double()
    dis = counts / counts.sum(1, keepdim=True)
    return torch.clamp(classes * dis, max=1.0).sum(1).cpu().numpy()


def make_telemetry(traffic: Dict, model_bytes: Sequence[float],
                   coverage: np.ndarray, seed: int) -> Dict[str, np.ndarray]:
    """The paper's Table 4 system draws (the port's
    ``sample_system_telemetry``): uplink U[1, 5] x 10^4 bit/s, downlink
    U[4, 20] x 10^4 bit/s, CPU U[1, 10] GHz, U[1, 10] Megacycles a sample;
    t_cmp = cycles x samples x epochs / frequency."""
    rng = np.random.default_rng(seed)
    n = traffic["clients"]
    bits_u = rng.uniform(1e4, 5e4, n)
    bits_d = rng.uniform(4e4, 2e5, n)
    f_ghz = rng.uniform(1, 10, n)
    c_mc = rng.uniform(1, 10, n)
    samples = np.full(n, float(traffic["samples_per_client"]))
    return dict(
        model_bytes=np.asarray(model_bytes, float),
        uplink_rate=bits_u / 8.0, downlink_rate=bits_d / 8.0,
        compute_latency=c_mc * 1e6 * samples * traffic["local_epochs"]
        / (f_ghz * 1e9),
        num_samples=samples, label_coverage=np.asarray(coverage, float),
        train_loss=np.ones(n))


def model_bytes(params: Dict) -> int:
    return sum(t.numel() * t.element_size() for lay in params.values()
               for t in lay.values())


def make_inputs(cfg: Dict, traffic: Dict, seed: int,
                device: torch.device) -> Inputs:
    data_seed, weight_seed, tel_seed, protocol_seed = sub_seeds(seed, 4)
    gen = torch.Generator(device=device)
    gen.manual_seed(data_seed)
    y = lookup.module("labels", traffic["labels"]).draw(
        traffic, cfg["classes"], gen, device)
    x = make_images(cfg, y, gen)
    gen.manual_seed(weight_seed)
    client_spec, global_params, clients = lookup.module(
        "fleets", traffic["fleet"]).make(cfg, traffic, gen, device)
    tel = make_telemetry(traffic, [model_bytes(p) for p in clients],
                         label_coverage(y, cfg["classes"]), tel_seed)
    return Inputs(x, y, global_params, clients, client_spec, tel,
                  protocol_seed & 0x7FFFFFFF)
