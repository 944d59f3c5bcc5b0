"""Frozen counts of the model FLOPs a cell's local training does.

A sample's forward pass costs, per layer, 2 x (output elements) x
(fan-in) for a SAME convolution and 2 x d_in x d_out for a dense layer;
pools, biases and activations are not counted.  Training one sample (a
forward and a backward pass) counts 3 x its forward FLOPs, once per
sample step, with nothing recomputed."""

from __future__ import annotations

from typing import Dict, Sequence


def forward_flops(spec: Sequence, image: Sequence[int]) -> int:
    h, w, _ = image
    total = 0
    for layer in spec:
        if layer[0] == "conv":
            _, cin, cout, k = layer
            total += 2 * h * w * cout * k * k * cin
        elif layer[0] == "pool":
            h, w = h // 2, w // 2
        else:
            total += 2 * layer[1] * layer[2]
    return total


def train_flops_per_round(cfg: Dict, traffic: Dict,
                          client_spec: Sequence[int]) -> int:
    """Model FLOPs of one round's local training over the fleet: every
    client trains ``local_epochs`` epochs of whole minibatches (the
    remainder of a shard is not a step)."""
    batch = traffic["batch"]
    steps = traffic["local_epochs"] * (
        (traffic["samples_per_client"] - batch) // batch + 1)
    return sum(3 * forward_flops(cfg["specs"][j], cfg["image"])
               * steps * batch for j in client_spec)
