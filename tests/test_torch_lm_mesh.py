"""The port's LM serving on a (data, model) mesh (``repro_torch.launch.mesh.
LMMesh``, ``models.sharding.place``/``gather``, ``lm.forward``/``prefill``/
``make_serve_step`` with ``mesh=``) against the JAX package's LM on its
4-device host meshes, on the CPU.

One subprocess runs the JAX package with
``--xla_force_host_platform_device_count=4``: its jitted ``forward`` and
``serve_step`` logits for reduced gemma3-27b (on ``make_host_mesh`` (2, 2),
(4, 1) and (1, 4): the kv heads do not divide by 4 there) and reduced
qwen3-moe (on (2, 2), where ``_apply_moe_ep`` runs, and (4, 1), where the
blocked ``_apply_moe_gspmd`` runs), all in fp32, with each MoE layer's
routing (a ``jax.debug.callback`` tagged by the layer's router), and
``_apply_moe_ep`` / ``_apply_moe_gspmd`` of one layer alone.  qwen3-moe's
capacity factor is lowered to 1.0 so that blocks drop assignments.

Contracts:

* the JAX package's meshed MoE logits differ from its unmeshed ones (the
  blocking is visible);
* the port on virtual CPU shards of the same mesh is within 1e-4 of the
  largest logit of the JAX package's, forward and every serve step, and
  its MoE layers route equally and drop the same assignments;
* the port's EP and blocked paths of one layer match the JAX package's;
* every placed block has ``local_shape``'s shape under ``param_pspecs``
  and ``decode_state_pspecs``, ``gather`` of ``place`` is bit-exact, and
  each device's bytes are ``local_shape``'s count;
* families outside the slice raise on a multi-shard mesh and serve on a
  one-device mesh; the host mesh clamps as the JAX package's does.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, lm_params_to_mesh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve
from repro_torch.launch.mesh import LMMesh
from repro_torch.models import blocks, lm, moe, sharding
from repro_torch.models.config import MoEConfig

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-4                       # of the largest fp32 logit
MESHES = {"gemma": [(2, 2), (4, 1), (1, 4)], "moe": [(2, 2), (4, 1)]}
B = 4
SEQ = {"gemma": 20, "moe": 256}  # 20 > the reduced window; 1024 MoE tokens
STEPS = {"gemma": 20, "moe": 8}
LAYER_D, LAYER_T = 64, (4, 256)


def _cfgs(name):
    arch = {"gemma": "gemma3_27b", "moe": "qwen3_moe_30b_a3b"}[name]
    out = []
    for get in (jax_get_config, get_config):
        c = dataclasses.replace(get(arch, reduced=True),
                                param_dtype="float32",
                                compute_dtype="float32")
        if c.moe is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=1.0))
        out.append(c)
    return out


def _tokens(name, cfg):
    return np.random.default_rng(len(name)).integers(
        0, cfg.vocab_size, (B, SEQ[name])).astype(np.int32)


LAYER_MCFG = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                       capacity_factor=1.0)


_JAX = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import make_host_mesh
from repro.models import lm, moe
from repro.models.config import MoEConfig
assert len(jax.devices()) == 4
MESHES = %(meshes)r
B, SEQ, STEPS = %(b)r, %(seq)r, %(steps)r
ARCH = {"gemma": "gemma3_27b", "moe": "qwen3_moe_30b_a3b"}
out = {}
routes = []
real_route = moe.route

def recording_route(p, x, mcfg):
    ids, probs, aux = real_route(p, x, mcfg)
    jax.debug.callback(lambda tag, i: routes.append((float(tag),
                                                     np.asarray(i))),
                       p["router"][0, 0], ids)
    return ids, probs, aux

def dropped(ids, e, cap, nb):
    flat = ids.reshape(nb, -1)
    out = []
    for b in range(nb):
        _, keep = moe._positions_in_expert(jnp.asarray(flat[b]), e, cap)
        out.extend((np.flatnonzero(~np.asarray(keep)) + b * flat.shape[1]
                    ).tolist())
    return np.asarray(out, np.int64)

for name, shapes in MESHES.items():
    cfg = dataclasses.replace(get_config(ARCH[name], reduced=True),
                              param_dtype="float32", compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    p = lm.init_model(jax.random.PRNGKey(0), cfg)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(p)):
        out[f"{name}/param/{i}"] = np.asarray(leaf)
    toks = np.random.default_rng(len(name)).integers(
        0, cfg.vocab_size, (B, SEQ[name])).astype(np.int32)
    fwd = jax.jit(lambda p, t: lm.forward(p, cfg, {"tokens": t},
                                          remat=False)[0])
    if cfg.moe is not None:
        out[f"{name}/none/forward"] = np.asarray(fwd(p, toks))
    for shape in shapes:
        key = f"{name}/{shape[0]}x{shape[1]}"
        mesh = make_host_mesh(*shape)
        assert mesh.devices.shape == shape
        with jax.sharding.set_mesh(mesh):
            out[f"{key}/forward"] = np.asarray(jax.jit(
                lambda p, t: lm.forward(p, cfg, {"tokens": t},
                                        remat=False)[0])(p, toks))
            step = jax.jit(lm.make_serve_step(cfg))
            st = lm.init_decode_state(p, cfg, B, STEPS[name])
            got = []
            for t in range(STEPS[name]):
                lg, st = step(p, st, jnp.asarray(toks[:, t:t + 1]))
                got.append(np.asarray(lg))
            out[f"{key}/serve"] = np.stack(got)
            if cfg.moe is None:
                continue
            moe.route = recording_route
            routes.clear()
            jax.jit(lambda p, t: lm.forward(p, cfg, {"tokens": t},
                                            remat=False)[0])(
                p, toks).block_until_ready()
            moe.route = real_route
            t_all = B * SEQ[name]
            e = cfg.moe.num_experts
            info = moe._ep_mesh_info(t_all, e)
            nb = info[2] if info is not None else moe._data_shards(t_all)
            out[f"{key}/path"] = np.asarray(0 if info is None else 1)
            cap = moe._capacity(t_all // nb, cfg.moe)
            tags = sorted({tag for tag, _ in routes})
            routers = np.asarray(p["stack"]["super"]["p0"]["ff"]["router"]
                                 )[:, 0, 0]
            for tag, ids in routes:
                layer = int(np.argmin(np.abs(routers - tag)))
                out[f"{key}/ids/{layer}"] = ids
                out[f"{key}/dropped/{layer}"] = dropped(ids, e, cap, nb)
            assert len(tags) == len(routers)

# one MoE layer alone: the EP path on (2, 2), the blocked path on (4, 1)
mcfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                 capacity_factor=1.0)
key = jax.random.PRNGKey(7)
p = moe.init_moe(key, %(d)r, mcfg, "swiglu", jnp.float32)
x = jax.random.normal(jax.random.fold_in(key, 1), %(t)r + (%(d)r,))
for k_, v_ in p.items():
    out[f"layer/p/{k_}"] = np.asarray(v_)
out["layer/x"] = np.asarray(x)
t_all = x.shape[0] * x.shape[1]
with jax.sharding.set_mesh(make_host_mesh(2, 2)):
    info = moe._ep_mesh_info(t_all, 4)
    assert info is not None
    out["layer/ep"] = np.asarray(jax.jit(
        lambda p, x: moe._apply_moe_ep(p, x, mcfg, "swiglu", info)[0])(p, x))
with jax.sharding.set_mesh(make_host_mesh(4, 1)):
    assert moe._ep_mesh_info(t_all, 4) is None
    assert moe._data_shards(t_all) == 4
    out["layer/blocked"] = np.asarray(jax.jit(
        lambda p, x: moe._apply_moe_gspmd(p, x, mcfg, "swiglu")[0])(p, x))
out["layer/one"] = np.asarray(moe._apply_moe_gspmd(p, x, mcfg, "swiglu")[0])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax4(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm_mesh") / "jax4.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = textwrap.dedent(_JAX) % dict(
        meshes=MESHES, b=B, seq=SEQ, steps=STEPS, d=LAYER_D, t=LAYER_T)
    run = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                         timeout=300, capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(path))


def _jax_params(jax4, name, jcfg):
    treedef = jax.tree_util.tree_structure(jax_lm.abstract_params(jcfg))
    leaves = [jax4[f"{name}/param/{i}"] for i in range(treedef.num_leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _mesh(shape):
    return LMMesh.virtual("cpu", *shape)


class _Dispatches:
    """The port's routing ids and dropped assignments of each MoE layer,
    read from every ``moe.route`` / ``moe._positions_in_expert`` call of a
    meshed pass (their order: layer, then device, then block)."""

    def __init__(self, monkeypatch):
        self.calls = []
        real_route, real_pos = moe.route, moe._positions_in_expert

        def route(p, x, mcfg):
            ids, probs, aux = real_route(p, x, mcfg)
            self.calls.append(("route", ids.clone()))
            return ids, probs, aux

        def positions(flat_ids, e, cap):
            pos, keep = real_pos(flat_ids, e, cap)
            self.calls.append(("pos", flat_ids.clone(), e, keep.clone()))
            return pos, keep

        monkeypatch.setattr(moe, "route", route)
        monkeypatch.setattr(moe, "_positions_in_expert", positions)

    def layers(self, mesh, ep: bool, nb: int):
        """[(ids (T, k), sorted dropped global assignment ids)] per layer:
        EP calls come one per device (block = its row, its experts), the
        blocked path's one per device and block it holds."""
        per = mesh.size if ep else mesh.size * nb // mesh.n_rows
        assert len(self.calls) % (2 * per) == 0
        out = []
        for at in range(0, len(self.calls), 2 * per):
            chunk = self.calls[at:at + 2 * per]
            ids, dropped = {}, set()
            for n in range(per):
                _, blk_ids = chunk[2 * n]
                _, flat, e, keep = chunk[2 * n + 1]
                k = n if ep else n // (nb // mesh.n_rows)
                b = mesh.row(k) if ep else (
                    mesh.row(k) * (nb // mesh.n_rows)
                    + n % (nb // mesh.n_rows))
                ids.setdefault(b, blk_ids)
                local = flat < e - 1 if ep else torch.ones_like(keep)
                off = b * flat.shape[0]
                dropped |= {off + int(i) for i in
                            torch.nonzero(local & ~keep).flatten()}
            out.append((torch.cat([ids[b] for b in sorted(ids)]),
                        np.asarray(sorted(dropped), np.int64)))
        return out


# --------------------------------------------------------------- the LM ----

@pytest.mark.parametrize("name,shape", [(n, s) for n in MESHES
                                        for s in MESHES[n]],
                         ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_forward_and_serve_match_the_jax_mesh(jax4, name, shape,
                                              monkeypatch):
    jcfg, tcfg = _cfgs(name)
    jp = _jax_params(jax4, name, jcfg)
    mesh = _mesh(shape)
    tp = lm_params_to_mesh(jax.device_get(jp), tcfg, mesh)
    toks = torch.from_numpy(_tokens(name, jcfg))
    key = f"{name}/{shape[0]}x{shape[1]}"
    rec = _Dispatches(monkeypatch) if tcfg.moe is not None else None
    moe.reset_dispatch_counts()
    got, aux = lm.forward(tp, tcfg, {"tokens": toks}, mesh=mesh)
    assert got.dtype == torch.float32 and got.shape == (B, SEQ[name],
                                                        tcfg.vocab_size)
    assert _rel(got, jax4[f"{key}/forward"]) <= TOL
    if rec is not None:
        ep = bool(jax4[f"{key}/path"])
        counts = moe.dispatch_counts()
        assert counts["ep" if ep else "blocked"] == tcfg.num_layers
        t_all = B * SEQ[name]
        nb = mesh.n_rows if ep else moe.n_blocks(t_all, mesh.n_rows)
        layers_ = rec.layers(mesh, ep, nb)
        assert len(layers_) == tcfg.num_layers
        n_dropped = 0
        for i, (ids, dropped) in enumerate(layers_):
            np.testing.assert_array_equal(ids.numpy(),
                                          jax4[f"{key}/ids/{i}"])
            np.testing.assert_array_equal(dropped,
                                          jax4[f"{key}/dropped/{i}"])
            n_dropped += len(dropped)
        assert n_dropped > 0
        monkeypatch.undo()
        assert float(aux) > 0.0

    last = lm.prefill(tp, tcfg, {"tokens": toks}, mesh=mesh)
    assert _rel(last, jax4[f"{key}/forward"][:, -1]) <= TOL
    step = lm.make_serve_step(tcfg, mesh)
    st = lm.init_decode_state(tp, tcfg, B, STEPS[name], mesh=mesh)
    moe.reset_dispatch_counts()
    for t in range(STEPS[name]):
        lg, st = step(tp, st, toks[:, t:t + 1])
        assert _rel(lg, jax4[f"{key}/serve"][t]) <= TOL
    assert st.pos == STEPS[name]
    if tcfg.moe is not None:
        assert moe.dispatch_counts()["one_block"] == \
            tcfg.num_layers * STEPS[name]


def test_jax_mesh_blocking_changes_moe_outputs(jax4):
    """The capacity factor drops assignments: the meshed runs (2 EP
    blocks, 4 GSPMD blocks) differ from the unmeshed one, which the port
    reproduces unmeshed."""
    jcfg, tcfg = _cfgs("moe")
    none = jax4["moe/none/forward"]
    for shape in MESHES["moe"]:
        assert _rel(jax4[f"moe/{shape[0]}x{shape[1]}/forward"], none) > 0.05
    tp = lm_params_from_jax(jax.device_get(_jax_params(jax4, "moe", jcfg)),
                            "cpu")
    got, _ = lm.forward(tp, tcfg, {"tokens": torch.from_numpy(
        _tokens("moe", jcfg))})
    assert _rel(got, none) <= TOL


# ------------------------------------------------------- one MoE layer ----

def _layer_inputs(jax4):
    p = {k: torch.from_numpy(jax4[f"layer/p/{k}"])
         for k in ("router", "w_up", "w_gate", "w_down")}
    return p, torch.from_numpy(jax4["layer/x"]), LAYER_MCFG


def _layer_on_mesh(p, x, mcfg, mesh):
    specs = lm.param_pspecs(None, p, mesh)
    placed = sharding.place(p, specs, mesh)
    ps = [sharding.local_tree(placed.shards, specs, mesh, k)
          for k in range(mesh.size)]
    b, s, d = x.shape
    mb = blocks.MeshBatch.of(mesh, b, s, d)
    xs = [t.reshape(-1, d) for t in sharding.split(x, mb.spec, mesh)]
    ys, _ = moe.apply_moe_mesh(ps, xs, mb.ranges, mb.tokens, mcfg, "swiglu",
                               mesh, specs["w_up"][0])
    return sharding.unsplit([y.view(-1, s, d) for y in ys], mb.spec, mesh)


def test_ep_path_matches_apply_moe_ep(jax4):
    p, x, mcfg = _layer_inputs(jax4)
    moe.reset_dispatch_counts()
    y = _layer_on_mesh(p, x, mcfg, _mesh((2, 2)))
    assert moe.dispatch_counts() == {"one_block": 0, "blocked": 0, "ep": 1}
    assert _rel(y, jax4["layer/ep"]) <= 1e-5


def test_blocked_path_matches_apply_moe_gspmd(jax4):
    p, x, mcfg = _layer_inputs(jax4)
    moe.reset_dispatch_counts()
    y = _layer_on_mesh(p, x, mcfg, _mesh((4, 1)))
    assert moe.dispatch_counts() == {"one_block": 0, "blocked": 1, "ep": 0}
    assert _rel(y, jax4["layer/blocked"]) <= 1e-5
    # the same four blocks on one device, and one block
    y4, _ = moe.apply_moe(p, x, mcfg, "swiglu", n_blocks=4)
    assert _rel(y4, jax4["layer/blocked"]) <= 1e-5
    y1, _ = moe.apply_moe(p, x, mcfg, "swiglu")
    assert _rel(y1, jax4["layer/one"]) <= 1e-5
    assert _rel(y1, jax4["layer/blocked"]) > 1e-2
    assert [moe.n_blocks(t, 4) for t in (1024, 1000, 512, 256)] == \
        [4, 2, 2, 1]


# ---------------------------------------------------------- placement ----

@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("arch", ["gemma3_27b", "qwen3_moe_30b_a3b"])
def test_placed_blocks_are_local_shapes_and_gather_is_exact(arch, shape):
    cfg = get_config(arch, reduced=True)
    mesh = _mesh(shape)
    params = lm.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    placed = lm.place_params(params, cfg, mesh)
    specs = tree.named_values(placed.specs)
    for shard in placed.shards:
        for t, full, sp in zip(tree.named_values(shard),
                               tree.named_values(params), specs):
            assert tuple(t.shape) == sharding.local_shape(full.shape, sp,
                                                          mesh)
            assert t.is_contiguous() and t.dtype == full.dtype
    back = sharding.gather(placed)
    for a, b in zip(tree.leaves(back), tree.leaves(params)):
        assert torch.equal(a, b)
    per_dev = sharding.device_bytes(placed)
    assert per_dev == [sharding.local_bytes(params, placed.specs, mesh)] * \
        mesh.size
    # no device aliases another's storage, nor the source's
    ptrs = [t.data_ptr() for s in placed.shards for t in tree.leaves(s)]
    assert len(set(ptrs)) == len(ptrs)

    state = lm.init_decode_state(placed, cfg, 4, 8, mesh=mesh)
    shapes = lm.abstract_decode_state(cfg, 4, 8).stack
    want = lm.decode_state_pspecs(cfg, shapes, mesh)
    assert state.stack.specs == want
    for shard in state.stack.shards:
        for t, full, sp in zip(tree.named_values(shard),
                               tree.named_values(shapes),
                               tree.named_values(want)):
            assert tuple(t.shape) == sharding.local_shape(full.shape, sp,
                                                          mesh)
    if shape == (1, 4):      # 2 kv heads on 4 model shards: replicated
        cache = state.stack.shards[0]["super"]["p0"]
        assert cache.k.shape[-2] == cfg.num_kv_heads


def test_psum_and_gather_helpers():
    mesh = _mesh((2, 2))
    parts = [torch.full((2,), float(k)) for k in range(4)]
    out = sharding.psum_model(parts, mesh)
    assert [float(t[0]) for t in out] == [1.0, 1.0, 5.0, 5.0]
    assert out[0] is out[1]
    x = torch.arange(4 * 6, dtype=torch.float32).view(4, 6)
    sp = ("data", "model")
    blocks = sharding.split(x, sp, mesh)
    assert [tuple(b.shape) for b in blocks] == [(2, 3)] * 4
    assert torch.equal(sharding.unsplit(blocks, sp, mesh), x)
    assert torch.equal(sharding.unsplit(sharding.split(x, (None, "model"),
                                                       mesh),
                                        (None, "model"), mesh), x)
    assert [sharding.block_range("data", mesh, k, 4) for k in range(4)] == \
        [(0, 2), (0, 2), (2, 4), (2, 4)]
    # place pairs a leaf with the spec of the same name, whatever the
    # dicts' insertion order, and rejects specs of another tree
    t = {"w": x, "b": torch.arange(6.0)}
    placed = sharding.place(t, {"b": (None,), "w": sp}, mesh)
    assert [tuple(v.shape) for v in placed.shards[3].values()] == [(2, 3),
                                                                   (6,)]
    assert torch.equal(sharding.gather(placed)["w"], x)
    with pytest.raises(ValueError):
        sharding.place(t, {"a": (None,), "w": sp}, mesh)


# ---------------------------------------------------- meshes and serve ----

def test_lm_mesh_and_host_mesh():
    m = LMMesh.virtual("cpu", 2, 3)
    assert (m.axis_names, m.axis_sizes, m.size, m.n_rows, m.n_model) == (
        ("data", "model"), (2, 3), 6, 2, 3)
    assert m.coords(4) == {"data": 1, "model": 1} and m.row(4) == 1
    p = LMMesh.virtual("cpu", 2, 2, pod=2)
    assert p.axis_names == ("pod", "data", "model") and p.n_rows == 4
    assert p.coords(7) == {"pod": 1, "data": 1, "model": 1}
    assert sharding.spec("batch", shape=(8,), mesh=p) == (("pod", "data"),)
    with pytest.raises(ValueError):
        LMMesh((torch.device("cpu"),) * 3, (2, 2))
    with pytest.raises(ValueError):
        LMMesh((torch.device("cpu"),), (1, 1), ("model", "data"))
    h = mesh_mod.make_host_mesh(4, 1, device="cpu")
    assert h.axis_sizes == (1, 1) and h.devices == (torch.device("cpu"),)


def test_pod_mesh_matches_the_flat_mesh():
    """A (pod, data, model) mesh runs the same program as its flattened
    (pod * data, model) one."""
    _, tcfg = _cfgs("gemma")
    params = lm.init_model(tcfg, torch.Generator().manual_seed(4), "cpu")
    toks = torch.from_numpy(_tokens("gemma", tcfg))
    want, _ = lm.forward(params, tcfg, {"tokens": toks})
    m = LMMesh.virtual("cpu", 2, 1, pod=2)
    got, _ = lm.forward(lm.place_params(params, tcfg, m), tcfg,
                        {"tokens": toks}, mesh=m)
    assert _rel(got, want) <= 1e-5


def test_families_outside_the_slice_raise_on_a_mesh():
    cfg = get_config("jamba_1p5_large_398b", reduced=True)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((2, 4), dtype=torch.long)
    mesh = _mesh((2, 1))
    placed = lm.place_params(params, cfg, mesh)
    with pytest.raises(NotImplementedError, match="A19 item 3"):
        lm.prefill(placed, cfg, {"tokens": toks}, mesh=mesh)
    with pytest.raises(TypeError):
        lm.prefill(params, cfg, {"tokens": toks}, mesh=mesh)
    one = _mesh((1, 1))
    placed1 = lm.place_params(params, cfg, one)
    got = lm.prefill(placed1, cfg, {"tokens": toks}, mesh=one)
    assert torch.equal(got, lm.prefill(params, cfg, {"tokens": toks}))


def test_serve_main_on_a_virtual_mesh(capsys):
    seq = serve.main(["--arch", "gemma3_27b", "--device", "cpu", "--batch",
                      "2", "--steps", "3", "--sample", "greedy",
                      "--mesh", "2,2", "--virtual"])
    out = capsys.readouterr().out
    assert "mesh=(2, 2) virtual" in out and seq.shape == (2, 4)
    one = serve.main(["--arch", "gemma3_27b", "--device", "cpu", "--batch",
                      "2", "--steps", "3", "--sample", "greedy"])
    assert "mesh=(1, 1)" in capsys.readouterr().out
    assert torch.equal(seq[:, 0], one[:, 0])       # the same seeded request
    with pytest.raises(NotImplementedError, match="A19 item 3"):
        serve.main(["--arch", "xlstm_1p3b", "--device", "cpu", "--steps",
                    "1", "--mesh", "2,1", "--virtual"])
