"""FedDD's cross-pod sync on the production mesh, held against the JAX
package on the CPU (``repro.launch.perf_federated``).

On a reduced fp32 granite config and the mesh ``(pod=2, data=2,
model=2)``: the JAX package's ``build_sync``, compiled in one subprocess
over 8 placeholder devices, gives the collectives' operand bytes per
device (``collective_bytes_per_device`` of the partitioned HLO) and the
synced global parameters; the port runs every (data, model) cell's two
local shards as virtual pods.

* Bytes per device, per kind, equal for dense, feddd at D .4 and .8 and
  int8 at .6.  The dense mean's weight is psummed once a sync: XLA's CSE
  merges the reference's per-leaf psums of the same weight into one
  4-byte operand of its combined all-reduce, and the port counts it so.
* The synced parameters of every cell and pod: equal in the dense mode,
  within 1e-6 in the compacted modes (Eq. (20) summed in another order).
* ``python -m repro_torch.launch.perf_federated`` on the CPU writes its
  records (the reduced config in place of the full one).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch import perf_federated
from repro_torch.launch.federated import pod_mesh
from repro_torch.launch.mesh import ProductionMesh
from repro_torch.models import lm

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESH = ProductionMesh(("pod", "data", "model"), (2, 2, 2))
MODES = [("dense", 0.0, "none"), ("feddd", 0.4, "none"),
         ("feddd", 0.8, "none"), ("feddd", 0.6, "int8")]

_JAX_SYNC = r"""
import dataclasses, json, sys
import numpy as np, jax
from repro.configs import get_config
from repro.launch import perf_federated as pf
from repro.launch.hlo_analysis import collective_bytes_per_device

cfg = dataclasses.replace(get_config("granite_3_8b", reduced=True),
                          param_dtype="float32", compute_dtype="float32")
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
modes = json.loads(sys.argv[3])
data = np.load(sys.argv[1])
out, coll = {}, {}
with jax.sharding.set_mesh(mesh):
    for i, (mode, d, q) in enumerate(modes):
        fn, args, specs = pf.build_sync(cfg, mesh, mode, d, q)
        td = jax.tree_util.tree_structure(args[0])
        n = td.num_leaves
        old = jax.tree_util.tree_unflatten(
            td, [data[f"old{j}"] for j in range(n)])
        new = jax.tree_util.tree_unflatten(
            td, [data[f"new{j}"] for j in range(n)])
        jitted = jax.jit(fn, in_shardings=specs)
        coll[i] = collective_bytes_per_device(
            jitted.lower(*args).compile().as_text())
        for j, leaf in enumerate(jax.tree_util.tree_leaves(
                jitted(old, new))):
            out[f"{i}_{j}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
print(json.dumps(coll))
"""


def _cfg():
    return dataclasses.replace(get_config("granite_3_8b", reduced=True),
                               param_dtype="float32",
                               compute_dtype="float32")


def _block(x: np.ndarray, spec, coords) -> np.ndarray:
    """The block of a global array one device holds under ``spec`` (a
    ``shard_map`` in-spec): per dimension, the row-major index of the
    device over the entry's mesh axes."""
    sizes = dict(zip(MESH.axis_names, MESH.axis_sizes))
    sl = []
    for dim, e in zip(x.shape, spec):
        axes = (e,) if isinstance(e, str) else (e or ())
        idx, n = 0, 1
        for a in axes:
            idx = idx * sizes[a] + coords[a]
            n *= sizes[a]
        step = dim // n
        sl.append(slice(idx * step, (idx + 1) * step))
    return x[tuple(sl)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    cfg = _cfg()
    shapes = [tuple(t.shape) for t in tree.leaves(lm.abstract_params(cfg))]
    rng = np.random.default_rng(0)
    old = [(0.02 * rng.standard_normal(s)).astype(np.float32)
           for s in shapes]
    new = [(o + 1e-3 * rng.standard_normal(o.shape)).astype(np.float32)
           for o in old]
    d = tmp_path_factory.mktemp("sync")
    np.savez(d / "in.npz", **{f"old{j}": a for j, a in enumerate(old)},
             **{f"new{j}": a for j, a in enumerate(new)})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run(
        [sys.executable, "-c", _JAX_SYNC, str(d / "in.npz"),
         str(d / "out.npz"), json.dumps(MODES)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    coll = json.loads(res.stdout.strip().splitlines()[-1])
    outs = np.load(d / "out.npz")
    return old, new, coll, outs


@pytest.mark.parametrize("i", range(len(MODES)))
def test_sync_matches_jax_on_every_cell(i, jax_run):
    old, new, coll, outs = jax_run
    mode, d_rate, quant = MODES[i]
    cfg = _cfg()
    p_shape = lm.abstract_params(cfg)
    td = tree.flatten(p_shape)[1]
    specs, spec_td = tree.flatten(lm.param_pspecs(cfg, p_shape, MESH))
    assert spec_td == td
    want = [outs[f"{i}_{j}"] for j in range(len(specs))]
    pods = pod_mesh(2, "cpu")
    sync, local = perf_federated.build_sync(cfg, MESH, mode, d_rate, quant)
    cells = 0
    for dd in range(2):
        for mm in range(2):
            coords = [{"pod": p, "data": dd, "model": mm} for p in range(2)]
            olds = [tree.unflatten(td, [torch.from_numpy(np.ascontiguousarray(
                _block(a, s, c))) for a, s in zip(old, specs)])
                for c in coords]
            news = [tree.unflatten(td, [torch.from_numpy(np.ascontiguousarray(
                _block(a, s, c))) for a, s in zip(new, specs)])
                for c in coords]
            assert tree.leaves(tree.tree_map(lambda t: tuple(t.shape),
                                             olds[0])) == tree.leaves(local)
            got, counts = sync(olds, news, pods)
            assert counts == coll[str(i)]
            for p, c in enumerate(coords):
                for g, w, s in zip(tree.leaves(got[p]), want, specs):
                    w = _block(w, s, c)
                    if mode == "dense":
                        np.testing.assert_array_equal(g.numpy(), w)
                    else:
                        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                                   atol=1e-6)
            cells += 1
    assert cells == 4
    if mode == "feddd":
        # the compacted modes move less than the dense mean
        assert counts["all-gather"] > 0 and counts["all-reduce"] < sum(
            math.prod(s) * 4 for s in tree.leaves(local))


def test_keep_count_and_mode_tags():
    assert perf_federated.keep_count(128, 0.0) == 128
    assert perf_federated.keep_count(128, 0.8) == math.ceil(128 * 0.2)
    assert perf_federated.keep_count(3, 0.99) == 1
    assert [perf_federated.mode_tag(*m) for m in perf_federated.MODES] == [
        "fed_dense", "fed_feddd_d0", "fed_feddd_d40", "fed_feddd_d60",
        "fed_feddd_d80", "fed_feddd_d60_int8", "fed_feddd_d80_int8"]
    with pytest.raises(ValueError):
        perf_federated.build_sync(_cfg(), MESH, "sparse")


def test_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    cfg = _cfg()
    monkeypatch.setattr(perf_federated, "get_config", lambda arch: cfg)
    recs = perf_federated.main(["--device", "cpu", "--results-dir",
                                str(tmp_path)])
    assert [r["tag"] for r in recs] == [
        perf_federated.mode_tag(*m) for m in perf_federated.MODES]
    by = {r["tag"]: r["collective_bytes_per_device"] for r in recs}
    assert by["fed_dense"] > by["fed_feddd_d40"] > by["fed_feddd_d80"] > \
        by["fed_feddd_d80_int8"]
    assert all(r["importance_launches"] == 0 and r["device"] == "cpu"
               for r in recs)
    saved = json.loads((tmp_path / f"federated_sync_{cfg.name}.json")
                       .read_text())
    assert saved == recs
    assert "fed_feddd_d60_int8" in capsys.readouterr().out
    # --rates replaces the feddd rows only; the int8 rows stay at 0.6, 0.8
    recs = perf_federated.main(["--device", "cpu", "--results-dir",
                                str(tmp_path), "--rates", "0.5"])
    assert [r["tag"] for r in recs] == [
        "fed_dense", "fed_feddd_d50", "fed_feddd_d60_int8",
        "fed_feddd_d80_int8"]
    assert [(r["mode"], r["d_rate"], r["quant"]) for r in recs] == [
        ("dense", 0.0, "none"), ("feddd", 0.5, "none"),
        ("feddd", 0.6, "int8"), ("feddd", 0.8, "int8")]
