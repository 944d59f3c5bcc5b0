"""The frozen FLOP counts against torch's own count of the reference
model, at batch 1 on the CPU."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops, inputs
from perfbench.reference.feddd import Model

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {n: json.loads((ROOT / "perfbench" / "configs" / f"{n}.json")
                         .read_text())
           for n in ("cnn2-cifar10",)}
SPECS = [(n, i) for n, c in CONFIGS.items() for i in range(len(c["specs"]))]


@pytest.mark.parametrize("name,index", SPECS)
def test_forward_flops_match_counter(name, index):
    cfg = CONFIGS[name]
    spec = cfg["specs"][index]
    gen = torch.Generator().manual_seed(0)
    params = inputs.make_weights([spec], gen, torch.device("cpu"))[0]
    x = torch.zeros(1, *cfg["image"])
    with FlopCounterMode(display=False) as counter:
        Model(spec, "fp32", "cpu")(params, x)
    assert flops.forward_flops(spec, cfg["image"]) == \
        counter.get_total_flops()


def test_cnn2_round():
    cfg = CONFIGS["cnn2-cifar10"]
    assert flops.forward_flops(cfg["specs"][0], cfg["image"]) == 6_729_328
    traffic = {"batch": 50, "samples_per_client": 500, "local_epochs": 1}
    assert flops.train_flops_per_round(cfg, traffic, [0] * 100) == \
        3 * 6_729_328 * 50_000
