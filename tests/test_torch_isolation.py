"""The PyTorch port stands alone and never falls back silently.

* Importing every module of ``repro_torch`` pulls in neither ``jax`` nor
  any module of the JAX package ``repro`` (checked in a fresh process).
* Without a card, entry points raise unless ``device="cpu"`` is asked for.
* Architectures not ported yet raise with a pointer to ROADMAP.md; what
  the port does not take (scheme 'random' without a
  round key, an unknown scheme, codec or value width) raises as the JAX
  package does.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.comm import CommConfig
from repro_torch.core import protocol, selection
from repro_torch.fl import MLP_SPEC, init_cnn_spec

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for must in ("repro_torch.core.protocol", "repro_torch.quickstart",
                 "repro_torch.kernels.importance.ops",
                 "repro_torch.kernels.sparse_agg.ops",
                 "repro_torch.kernels.masked_merge.ops",
                 "repro_torch.convert", "repro_torch.models.lm",
                 "repro_torch.models.attention",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.launch.serve", "repro_torch.prng",
                 "repro_torch.comm.codecs", "repro_torch.comm.quantize",
                 "repro_torch.comm.payload", "repro_torch.obs",
                 "repro_torch.obs.metrics", "repro_torch.obs.recorder",
                 "repro_torch.obs.runlog", "repro_torch.obs.report",
                 "repro_torch.core.convergence",
                 "repro_torch.core.coverage",
                 "repro_torch.heterogeneous",
                 "repro_torch.fl.heterogeneity",
                 "repro_torch.sim", "repro_torch.sim.engine",
                 "repro_torch.sim.network", "repro_torch.sim.policies",
                 "repro_torch.sim.faults", "repro_torch.sim.outages",
                 "repro_torch.sim.runner", "repro_torch.sim.crash_resume",
                 "repro_torch.straggler_sim", "repro_torch.population",
                 "repro_torch.population.availability",
                 "repro_torch.population.sampler",
                 "repro_torch.population.store", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.io",
                 "repro_torch.checkpoint.run_state",
                 "repro_torch.launch.mesh",
                 "repro_torch.core.sparse_collective",
                 "repro_torch.optim", "repro_torch.optim.optimizers",
                 "repro_torch.data.pipeline", "repro_torch.models.moe",
                 "repro_torch.launch.specs", "repro_torch.launch.train",
                 "repro_torch.launch.federated",
                 "repro_torch.federated_pods",
                 "repro_torch.configs.qwen3_moe_30b_a3b",
                 "repro_torch.configs.granite_moe_1b_a400m",
                 "repro_torch.models.sharding", "repro_torch.launch.dryrun",
                 "repro_torch.launch.hlo_analysis",
                 "repro_torch.launch.analytic_cost",
                 "repro_torch.launch.perf_federated",
                 "repro_torch.models.layers", "repro_torch.models.mlp",
                 "repro_torch.models.blocks"):
        assert must in res["modules"]


def _tiny_run(**kw):
    params = init_cnn_spec(MLP_SPEC, device="cpu")
    from repro_torch.fl import sample_system_telemetry
    tel = sample_system_telemetry(2, [1e5, 1e5], [10, 10], [1.0, 1.0])
    return protocol.run_scheme("feddd", params, tel,
                               lambda p, i, g: (p, 1.0), rounds=1, **kw)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tiny_run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cnn_spec(MLP_SPEC)
    assert _tiny_run(device="cpu").history[0].round == 1


def test_random_selection_raises():
    """Scheme 'random' draws from the round key: without one it raises."""
    x = {"w": torch.ones(2, 4, 3)}
    with pytest.raises(ValueError, match="requires rng"):
        selection.build_masks_batched(
            x, x, np.zeros(2),
            config=selection.SelectionConfig(scheme="random"))


@pytest.mark.parametrize("kw", [dict(sim=True), dict(faults="random"),
                                dict(population="always"), dict(mesh=2),
                                dict(checkpoint_every=1),
                                dict(resume_from="state.npz")])
def test_unported_paths_raise(kw, tmp_path):
    """Every FedDD path of the JAX package is ported: the simulator, the
    fault layer, population serving, crash-resume (a checkpoint needs a
    path, a resume an existing snapshot) and the client-sharded mesh,
    whose ``mesh=2`` clamps to the CPU's one device and equals the run
    without a mesh bit for bit."""
    from repro_torch import sim
    from repro_torch.population import Population
    from repro_torch.fl import sample_system_telemetry
    if "mesh" in kw:
        got, want = _tiny_run(device="cpu", **kw), _tiny_run(device="cpu")
        assert tree.leaves(got.global_params) and all(
            torch.equal(a, b) for a, b in zip(
                tree.leaves(got.global_params),
                tree.leaves(want.global_params)))
        assert [r.sim_time for r in got.history] == \
            [r.sim_time for r in want.history]
    elif "checkpoint_every" in kw:
        with pytest.raises(ValueError, match="checkpoint_path"):
            _tiny_run(device="cpu", **kw)
        res = _tiny_run(device="cpu", checkpoint_path=str(tmp_path / "c"),
                        **kw)
        assert (tmp_path / "c.meta").exists() and len(res.history) == 1
    elif "resume_from" in kw:
        with pytest.raises(FileNotFoundError):
            _tiny_run(device="cpu", resume_from=str(tmp_path / "none.npz"))
    else:
        if "faults" in kw:
            kw = dict(faults=sim.RandomFaults(crash_rate=0.5))
        if "population" in kw:
            kw = dict(population=Population(sample_system_telemetry(
                2, [1e5, 1e5], [10, 10], [1.0, 1.0])))
        assert isinstance(_tiny_run(device="cpu", **kw), sim.SimResult)


def test_unported_schemes_and_codecs_raise():
    """Every scheme and wire format is ported: an unknown scheme, codec or
    value width raises as in the JAX package; every field of the JAX
    package's ProtocolConfig is taken (the client mesh among them)."""
    for scheme in ("feddd", "fedavg", "fedcs", "oort"):
        assert protocol.ProtocolConfig(scheme=scheme).scheme == scheme
    with pytest.raises(ValueError, match="scheme"):
        protocol.ProtocolConfig(scheme="fedprox")
    assert protocol.ProtocolConfig(mesh=2).mesh == 2
    assert protocol.ProtocolConfig(population=100).population == 100
    with pytest.raises(ValueError, match="codec"):
        CommConfig(codec="gzip")
    with pytest.raises(ValueError, match="qbits"):
        CommConfig(qbits=4)
    assert not CommConfig(codec="bitmask", qbits=8).is_default


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "jamba-1.5-large-398b",
                                  "xlstm_1p3b", "pixtral_12b",
                                  "whisper_medium", "granite_moe_1b_a400m"])
def test_unported_architectures_raise(arch):
    """Every family is ported now (the name is kept from when the SSM,
    xLSTM, VLM and audio families raised): each of these ids, the MoE
    ones and those that raised until then, loads with the JAX registry's
    family, and its reduced model builds on the CPU."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch, reduced=True)
    assert cfg.family == jax_get_config(arch, reduced=True).family
    assert get_config(arch).family == cfg.family
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    assert ("encoder" in params) == cfg.is_encdec


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = get_config("gemma3_27b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_model(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--steps", "1"])
    # a mesh, virtual or of the host's cards, never steps down to the CPU
    from repro_torch.launch.mesh import LMMesh, make_host_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMMesh.virtual(None, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--steps", "1", "--mesh", "2,2", "--virtual"])


def test_train_on_a_mesh_raises_without_a_card(monkeypatch):
    """The train entry point's meshes, virtual or of the host's cards, never
    step down to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch import train
    for argv in (["--mesh", "2,2", "--virtual"], ["--mesh", "2,2"],
                 ["--production-mesh", "--virtual"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--steps", "1"] + argv)


def test_tree_order_is_sorted_depth_first():
    t = {"b": {"y": 1, "x": 2}, "a": 3, "c": {"z": {"k": 4}}}
    leaves, td = tree.flatten(t)
    assert leaves == [3, 2, 1, 4]
    assert tree.unflatten(td, leaves) == t
    assert tree.tree_map(lambda v, w: v + w, t, t)["b"]["x"] == 4
    with pytest.raises(ValueError):
        tree.tree_map(lambda v, w: v, t, {"a": 1})
