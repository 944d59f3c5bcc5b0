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
* every family runs on a multi-shard mesh (``test_torch_lm_mesh_families.
  py`` holds jamba, xlstm, pixtral and whisper against the JAX package)
  and serves on a one-device mesh; the host mesh clamps as the JAX
  package's does.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro.optim import optimizers as jopt
from repro_torch import tree
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import (lm_params_from_jax, lm_params_to_mesh,
                                 to_numpy, train_state_to_mesh)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import LMMesh
from repro_torch.models import blocks, lm, moe, sharding
from repro_torch.models.config import MoEConfig
from repro_torch.optim import optimizers as topt

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-4                       # of the largest fp32 logit
MESHES = {"gemma": [(2, 2), (4, 1), (1, 4)], "moe": [(2, 2), (4, 1)]}
TRAIN_MESHES = {"gemma": [(2, 2), (4, 1)], "moe": [(2, 2), (4, 1)]}
LR = 1e-3                        # AdamW's, one step from the JAX state
B = 4
SEQ = {"gemma": 20, "moe": 256}  # 20 > the reduced window; 1024 MoE tokens
STEPS = {"gemma": 20, "moe": 8}
LAYER_D, LAYER_T = 64, (4, 256)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the meshed passes run many small ops, which a
    thread pool per xdist worker oversubscribes many times over; and
    bit-for-bit comparisons of two runs need a fixed GEMM blocking."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
from repro.optim import adamw
assert len(jax.devices()) == 4
MESHES = %(meshes)r
TRAIN_MESHES, LR = %(train)r, %(lr)r
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
    # one AdamW step from (p, zero moments): its loss, grad norm, moments
    # and params (the step's gradient is m / (1 - b1))
    opt = adamw(LR)
    for shape in TRAIN_MESHES[name]:
        key = f"{name}/{shape[0]}x{shape[1]}/train"
        with jax.sharding.set_mesh(make_host_mesh(*shape)):
            st, m = jax.jit(lm.make_train_step(cfg, opt))(
                lm.TrainState(p, opt.init(p), jnp.zeros((), jnp.int32)),
                {"tokens": jnp.asarray(toks)})
        for k_ in ("loss", "grad_norm"):
            out[f"{key}/{k_}"] = np.asarray(m[k_])
        for part in ("m", "v"):
            for i, leaf in enumerate(jax.tree_util.tree_leaves(
                    st.opt_state[part])):
                out[f"{key}/{part}/{i}"] = np.asarray(leaf)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(st.params)):
            out[f"{key}/param/{i}"] = np.asarray(leaf)

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
# the gradients of <y, ct> + aux through the EP path and the blocked path
# at its 2 blocks on (2, 2): the same function
ct = jax.random.normal(jax.random.fold_in(key, 2), x.shape)
out["layer/ct"] = np.asarray(ct)
with jax.sharding.set_mesh(make_host_mesh(2, 2)):
    info = moe._ep_mesh_info(t_all, 4)
    assert moe._data_shards(t_all) == info[2] == 2
    paths = {"ep": lambda p, x: moe._apply_moe_ep(p, x, mcfg, "swiglu", info),
             "blocked": lambda p, x: moe._apply_moe_gspmd(p, x, mcfg,
                                                          "swiglu")}
    for tag, fn in paths.items():
        def f(p, x, fn=fn):
            y, a = fn(p, x)
            return jnp.sum(y * ct) + a
        gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(p, x)
        for k_, v_ in gp.items():
            out[f"layer/grad_{tag}/{k_}"] = np.asarray(v_)
        out[f"layer/grad_{tag}/x"] = np.asarray(gx)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax4(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm_mesh") / "jax4.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = textwrap.dedent(_JAX) % dict(
        meshes=MESHES, b=B, seq=SEQ, steps=STEPS, d=LAYER_D, t=LAYER_T,
        train=TRAIN_MESHES, lr=LR)
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
    """Jamba (Mamba, attention and MoE layers) prefills on a
    (2, 1) mesh as unmeshed (fp32, its experts given room for every
    token); unplaced parameters on a mesh raise, and a one-device mesh
    runs the unmeshed code, bit for bit."""
    cfg = get_config("jamba_1p5_large_398b", reduced=True)
    cfg = dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=float(
            cfg.moe.num_experts)))
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((2, 4), dtype=torch.long)
    mesh = _mesh((2, 1))
    placed = lm.place_params(params, cfg, mesh)
    want = lm.prefill(params, cfg, {"tokens": toks})
    got = lm.prefill(placed, cfg, {"tokens": toks}, mesh=mesh)
    assert got.shape == (2, cfg.vocab_size) and _rel(got, want) <= 1e-5
    with pytest.raises(TypeError):
        lm.prefill(params, cfg, {"tokens": toks}, mesh=mesh)
    one = _mesh((1, 1))
    placed1 = lm.place_params(params, cfg, one)
    got = lm.prefill(placed1, cfg, {"tokens": toks}, mesh=one)
    assert torch.equal(got, want)


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
    xl = serve.main(["--arch", "xlstm_1p3b", "--device", "cpu", "--batch",
                     "2", "--steps", "1", "--sample", "greedy", "--mesh",
                     "2,1", "--virtual"])
    assert "mesh=(2, 1) virtual" in capsys.readouterr().out
    assert xl.shape == (2, 2)


# ------------------------------------------------------------ training ----

def _adam_first_step_close(p0, got, want, m, m_got=None) -> None:
    """``tests/test_torch_train.py``'s rule for Adam's first step: params
    at 2e-5 wherever the step's gradient g = m / (1 - b1) is 0 or |g| >=
    1e-6 (over 99% of the elements); where |g| is ~eps a gradient two
    summation orders give 1e-9 apart moves a parameter by a share of lr,
    so there the step's own bound, lr * (1 + wd * |p|).  With ``m_got``
    (the step's own first moments) an exact 0 counts only where both
    gradients are 0: one side's summation noise against the other's 0 is
    such a pair."""
    n_cond = n_all = 0
    for i, (p, a, b, mi) in enumerate(zip(p0, got, want, m)):
        err = np.abs(np.asarray(a) - np.asarray(b))
        g = np.asarray(mi) / np.float32(0.1)
        zero = g == 0
        if m_got is not None:
            zero &= np.asarray(m_got[i]) == 0
        conditioned = (np.abs(g) >= 1e-6) | zero
        assert float(err[conditioned].max(initial=0.0)) <= 2e-5
        assert np.all(err <= LR * (1 + 0.1 * np.abs(p)) + 2e-5)
        n_cond += int(conditioned.sum())
        n_all += conditioned.size
    assert n_cond > 0.99 * n_all


def _replicas_equal(placed) -> int:
    """Asserts every replica of every block equals its first holder's, bit
    for bit; returns how many replicas were compared."""
    per = [tree.named_values(sh) for sh in placed.shards]
    n = 0
    for i, sp in enumerate(tree.named_values(placed.specs)):
        for ks in sharding.holders(sp, placed.mesh):
            for k in ks[1:]:
                assert torch.equal(per[k][i], per[ks[0]][i])
                n += 1
    return n


def _local_shapes(placed, whole) -> None:
    for sh in placed.shards:
        for t, full, sp in zip(tree.named_values(sh),
                               tree.named_values(whole),
                               tree.named_values(placed.specs)):
            assert tuple(t.shape) == sharding.local_shape(full.shape, sp,
                                                          placed.mesh)


@pytest.mark.parametrize("name,shape", [(n, s) for n in TRAIN_MESHES
                                        for s in TRAIN_MESHES[n]],
                         ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_train_step_matches_the_jax_mesh(jax4, name, shape, monkeypatch):
    """One AdamW step on the mesh from the JAX package's state, carried by
    ``convert.train_state_to_mesh``: loss and grad norm at 2e-5, the
    gathered gradients of ``value_and_grad(mesh=)`` at 1e-4 of each leaf's
    largest (the JAX step's is m / (1 - b1)), m and v leaf for leaf at
    1e-6, and the params by ``tests/test_torch_train.py``'s rule for
    Adam's first step (2e-5 wherever g = 0 or |g| >= 1e-6, the step's
    own bound elsewhere).  MoE layers route as the JAX mesh routes and
    drop the same assignments, in the forward and in the recompute
    (remat, in reverse layer order).  After the step every replica is
    bit-equal and every block has ``local_shape``'s shape."""
    jcfg, tcfg = _cfgs(name)
    jp = _jax_params(jax4, name, jcfg)
    js = jax_lm.TrainState(jp, jopt.adamw(LR).init(jp),
                           jnp.zeros((), jnp.int32))
    mesh = _mesh(shape)
    ts = train_state_to_mesh(jax.device_get(js), tcfg, mesh)
    whole = lm_params_from_jax(jax.device_get(jp), "cpu")
    _local_shapes(ts.params, whole)
    toks = torch.from_numpy(_tokens(name, jcfg))
    key = f"{name}/{shape[0]}x{shape[1]}"
    n = tcfg.num_layers

    rec = _Dispatches(monkeypatch) if tcfg.moe is not None else None
    moe.reset_dispatch_counts()
    _, _, grads = lm.value_and_grad(ts.params, tcfg, {"tokens": toks},
                                    mesh=mesh)
    if rec is not None:
        ep = bool(jax4[f"{key}/path"])
        assert moe.dispatch_counts()["ep" if ep else "blocked"] == 2 * n
        nb = mesh.n_rows if ep else moe.n_blocks(B * SEQ[name], mesh.n_rows)
        layers_ = rec.layers(mesh, ep, nb)
        assert len(layers_) == 2 * n
        for i, (ids, dropped) in enumerate(layers_[:n]):
            np.testing.assert_array_equal(ids.numpy(),
                                          jax4[f"{key}/ids/{i}"])
            np.testing.assert_array_equal(dropped,
                                          jax4[f"{key}/dropped/{i}"])
            again_ids, again_dropped = layers_[2 * n - 1 - i]
            assert torch.equal(again_ids, ids)
            np.testing.assert_array_equal(again_dropped, dropped)
        monkeypatch.undo()
    _replicas_equal(grads)
    b1 = np.float32(0.1)
    for i, g in enumerate(tree.leaves(to_numpy(sharding.gather(grads)))):
        want = jax4[f"{key}/train/m/{i}"] / b1
        assert np.abs(g - want).max() <= 1e-4 * max(np.abs(want).max(),
                                                    1e-30)

    p0 = tree.leaves(to_numpy(whole))
    ts2, tm = lm.make_train_step(tcfg, topt.adamw(LR), mesh=mesh)(
        ts, {"tokens": toks})
    for k in ("loss", "grad_norm"):
        want = float(jax4[f"{key}/train/{k}"])
        assert abs(float(tm[k]) - want) <= 2e-5 * max(1.0, abs(want)), k
    assert int(ts2.step) == 1
    opt = sharding.gather(ts2.opt_state)
    for part in ("m", "v"):
        for i, got in enumerate(tree.leaves(to_numpy(opt[part]))):
            np.testing.assert_allclose(got, jax4[f"{key}/train/{part}/{i}"],
                                       rtol=0, atol=1e-6)
    _adam_first_step_close(
        p0, tree.leaves(to_numpy(sharding.gather(ts2.params))),
        [jax4[f"{key}/train/param/{i}"] for i in range(len(p0))],
        [jax4[f"{key}/train/m/{i}"] for i in range(len(p0))])
    assert _replicas_equal(ts2.params) + _replicas_equal(ts2.opt_state) > 0
    _local_shapes(ts2.params, whole)
    _local_shapes(sharding.Placed(mesh, ts2.opt_state.specs["m"], tuple(
        sh["m"] for sh in ts2.opt_state.shards)), whole)


def test_jax_ep_gradient_equals_its_blocked_gradient(jax4):
    """The JAX package's ``_apply_moe_ep`` differentiates a ``psum``
    inside ``shard_map(check_vma=False)``; its gradient (params and
    input, aux loss included) equals the blocked path's at the same 2
    blocks.  The port's EP path on (2, 2) and its blocked path on (2, 1)
    (2 blocks), under autograd and ``reduce_replicas``, give the same
    gradients."""
    p, x, mcfg = _layer_inputs(jax4)
    ct = torch.from_numpy(jax4["layer/ct"])
    names = ["router", "w_up", "w_gate", "w_down", "x"]
    for k in names:
        want = jax4[f"layer/grad_blocked/{k}"]
        assert _rel(jax4[f"layer/grad_ep/{k}"], want) <= 1e-5, k
    for shape, path in (((2, 2), "ep"), ((2, 1), "blocked")):
        mesh = _mesh(shape)
        specs = lm.param_pspecs(None, p, mesh)
        placed = sharding.place(p, specs, mesh)
        req = [{k: t.requires_grad_(True) for k, t in sh.items()}
               for sh in placed.shards]
        xr = x.clone().requires_grad_(True)
        moe.reset_dispatch_counts()
        y, aux = _layer_on_mesh_live(req, specs, xr, mcfg, mesh)
        assert moe.dispatch_counts()[path] == 1
        grads = torch.autograd.grad(torch.sum(y * ct) + aux,
                                    [t for sh in req for t in sh.values()]
                                    + [xr])
        flat = list(grads[:-1])
        g = sharding.gather(sharding.reduce_replicas(sharding.Placed(
            mesh, specs, tuple(dict(zip(sh, flat[i * len(sh):
                                                 (i + 1) * len(sh)]))
                               for i, sh in enumerate(req)))))
        for k in names[:-1]:
            assert _rel(g[k], jax4[f"layer/grad_{path}/{k}"]) <= 1e-5, k
        assert _rel(grads[-1], jax4[f"layer/grad_{path}/x"]) <= 1e-5


def _layer_on_mesh_live(shards, specs, x, mcfg, mesh):
    """One MoE layer on ``mesh`` from every device's blocks ``shards``
    (which may require grad): (y gathered, aux)."""
    ps = [sharding.local_tree(shards, specs, mesh, k)
          for k in range(mesh.size)]
    b, s, d = x.shape
    mb = blocks.MeshBatch.of(mesh, b, s, d)
    xs = [t.reshape(-1, d) for t in sharding.split(x, mb.spec, mesh)]
    ys, aux = moe.apply_moe_mesh(ps, xs, mb.ranges, mb.tokens, mcfg,
                                 "swiglu", mesh, specs["w_up"][0])
    return sharding.unsplit([y.view(-1, s, d) for y in ys], mb.spec,
                            mesh), aux


def test_reduce_replicas_and_global_sq_norm_by_hand():
    """On a (2, 2) mesh: a leaf cut by data and model has no replicas; one
    cut by data only is summed over model; a replicated one over all
    four devices, in device order, the sum handed to every holder; the
    squared norm counts each distinct block once."""
    mesh = _mesh((2, 2))
    specs = {"full": ("data", "model"), "rows": ("data", None),
             "rep": (None,)}
    shards = tuple({"full": torch.full((1, 1), 1.0 + k),
                    "rows": torch.full((1, 2), 10.0 * (k + 1)),
                    "rep": torch.tensor([2.0 ** k, 0.5])}
                   for k in range(4))
    red = sharding.reduce_replicas(sharding.Placed(mesh, specs, shards))
    assert [float(sh["full"]) for sh in red.shards] == [1.0, 2.0, 3.0, 4.0]
    assert [sh["rows"].tolist() for sh in red.shards] == \
        [[[30.0, 30.0]]] * 2 + [[[70.0, 70.0]]] * 2
    assert all(sh["rep"].tolist() == [15.0, 2.0] for sh in red.shards)
    assert red.shards[0]["rep"] is red.shards[3]["rep"]
    assert sharding.holders(("data", None), mesh) == [[0, 1], [2, 3]]
    assert sharding.holders((None,), mesh) == [[0, 1, 2, 3]]
    pod = LMMesh.virtual("cpu", 2, 1, pod=2)       # replicas over pod too
    assert sharding.holders(("data", None), pod) == [[0, 2], [1, 3]]
    want = (1 + 4 + 9 + 16) + 2 * 900 + 2 * 4900 + (15 ** 2 + 4)
    assert float(sharding.global_sq_norm(red)) == want
    # the whole tree's norm, whatever the placement
    t = {"a": torch.randn(4, 6), "b": torch.randn(6)}
    sq = sum(float(torch.sum(v * v)) for v in t.values())
    for sp in ({"a": ("data", "model"), "b": ("model",)},
               {"a": (None, "data"), "b": (None,)}):
        got = float(sharding.global_sq_norm(sharding.place(t, sp, mesh)))
        assert abs(got - sq) <= 1e-5 * sq


def test_gathered_blocks_carry_gradients_back():
    """``assemble``'s copies into a fresh tensor are recorded by autograd
    (``CopySlices``): each block read gets the gradient of its slice, and
    a block no device read gets none."""
    mesh = _mesh((2, 2))
    w = torch.randn(4, 6)
    placed = sharding.place({"w": w}, {"w": ("data", "model")}, mesh)
    leaves = [sh["w"].requires_grad_(True) for sh in placed.shards]
    full = sharding.local_tree([{"w": t} for t in leaves],
                               {"w": ("data", "model")}, mesh, 0)["w"]
    assert full.shape == (4, 3) and full.grad_fn is not None
    ct = torch.randn(4, 3)
    g = torch.autograd.grad((full * ct).sum(), leaves, allow_unused=True)
    assert torch.equal(g[0], ct[:2]) and torch.equal(g[2], ct[2:])
    assert g[1] is None and g[3] is None


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_meshed_adafactor_equals_unmeshed(shape):
    """Adafactor on placed blocks (the row and column means over the
    whole leaf, ``vr``/``vc`` whole on every device), gathered, equals
    adafactor on the whole tree at 1e-6 over 3 steps; the replicas of
    ``vr``/``vc`` are bit-equal."""
    cfg = get_config("gemma3_27b", reduced=True)
    params = lm.init_model(dataclasses.replace(cfg, param_dtype="float32"),
                           torch.Generator().manual_seed(5), "cpu")
    mesh = _mesh(shape)
    opt = topt.adafactor(1e-2)
    state = opt.init(params)
    specs = lm.train_state_pspecs(cfg, lm.TrainState(params, state, None),
                                  mesh)
    pp = sharding.place(params, specs.params, mesh)
    ps = sharding.place(state, specs.opt_state, mesh)
    assert all(sp == (None,) * len(sp) for sp in
               tree.named_values(specs.opt_state["v"]))
    gen = torch.Generator().manual_seed(6)
    for _ in range(3):
        grads = tree.tree_map(lambda p: torch.randn(p.shape, generator=gen),
                              params)
        up, state = opt.update(grads, state, params)
        params = topt.apply_updates(params, up)
        gp = sharding.place(grads, specs.params, mesh)
        ups, ps = topt.update_placed(opt, gp, ps, pp)
        pp = sharding.Placed(mesh, pp.specs, tuple(
            topt.apply_updates(p, u) for p, u in zip(pp.shards, ups.shards)))
    for a, b in zip(tree.leaves(sharding.gather(pp)), tree.leaves(params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for a, b in zip(tree.leaves(sharding.gather(ps)), tree.leaves(state)):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=1e-6)
    assert _replicas_equal(ps) > 0


def _gemma_state(opt, seed=8):
    _, tcfg = _cfgs("gemma")
    params = lm.init_model(tcfg, torch.Generator().manual_seed(seed), "cpu")
    return tcfg, lm.TrainState(params, opt.init(params),
                               torch.zeros((), dtype=torch.int32))


def test_microbatched_meshed_step_matches_unmeshed():
    """A (2, 2) AdamW step of 2 microbatches (each split over data) within
    2e-5 of the unmeshed one: loss, grad norm and moments, and the params
    by Adam's first-step rule."""
    opt = topt.adamw(LR)
    tcfg, state = _gemma_state(opt)
    p0 = tree.leaves(to_numpy(state.params))
    toks = torch.from_numpy(_tokens("gemma", tcfg))
    mesh = _mesh((2, 2))
    placed = lm.place_train_state(state, tcfg, mesh)
    got, gm = lm.make_train_step(tcfg, opt, 2, mesh=mesh)(
        placed, {"tokens": toks})
    want, wm = lm.make_train_step(tcfg, opt, 2)(state, {"tokens": toks})
    for k in ("loss", "grad_norm"):
        assert abs(float(gm[k]) - float(wm[k])) <= 2e-5 * abs(float(wm[k]))
    for a, b in zip(tree.leaves(sharding.gather(got.opt_state)),
                    tree.leaves(want.opt_state)):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=2e-5)
    _adam_first_step_close(p0, tree.leaves(to_numpy(sharding.gather(
        got.params))), tree.leaves(to_numpy(want.params)),
        tree.leaves(to_numpy(want.opt_state["m"])))
    assert _replicas_equal(got.params) > 0


def test_pod_mesh_step_equals_the_flat_step():
    """A ("pod", "data", "model") (2, 1, 2) step equals the flat (2, 2)
    step bit for bit: the same rows, the same replicas, the same sums in
    the same order."""
    opt = topt.adamw(LR)
    out = []
    for m in (_mesh((2, 2)), LMMesh.virtual("cpu", 1, 2, pod=2)):
        tcfg, state = _gemma_state(opt)
        toks = torch.from_numpy(_tokens("gemma", tcfg))
        st = lm.place_train_state(state, tcfg, m)
        step = lm.make_train_step(tcfg, opt, mesh=m)
        for _ in range(2):
            st, metrics = step(st, {"tokens": toks})
        out.append((st, metrics))
    (a, am), (b, bm) = out
    assert float(am["loss"]) == float(bm["loss"])
    assert float(am["grad_norm"]) == float(bm["grad_norm"])
    for x, y in zip(tree.leaves(sharding.gather(a.params))
                    + tree.leaves(sharding.gather(a.opt_state)),
                    tree.leaves(sharding.gather(b.params))
                    + tree.leaves(sharding.gather(b.opt_state))):
        assert torch.equal(x, y)


def test_one_device_mesh_trains_unmeshed_and_others_raise():
    """A (1, 1) mesh runs the unmeshed step on its device (bit-equal) and
    keeps the state placed; xlstm takes a finite meshed
    ``value_and_grad`` on (2, 1), its loss the unmeshed one's."""
    opt = topt.adamw(LR)
    tcfg, state = _gemma_state(opt)
    toks = torch.from_numpy(_tokens("gemma", tcfg))
    one = _mesh((1, 1))
    placed = lm.place_train_state(state, tcfg, one)
    got, gm = lm.make_train_step(tcfg, opt, mesh=one)(placed,
                                                      {"tokens": toks})
    assert isinstance(got.params, sharding.Placed)
    want, wm = lm.make_train_step(tcfg, opt)(state, {"tokens": toks})
    assert float(gm["loss"]) == float(wm["loss"])
    for a, b in zip(tree.leaves(got.params.shards[0]),
                    tree.leaves(want.params)):
        assert torch.equal(a, b)
    cfg = dataclasses.replace(get_config("xlstm_1p3b", reduced=True),
                              param_dtype="float32")
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = _mesh((2, 1))
    batch = {"tokens": torch.arange(8).view(2, 4)}
    loss, _, grads = lm.value_and_grad(lm.place_params(params, cfg, mesh),
                                       cfg, batch, mesh=mesh)
    want, _, _ = lm.value_and_grad(params, cfg, batch)
    assert bool(torch.isfinite(loss)) and abs(float(loss - want)) <= 1e-5
    assert all(bool(torch.isfinite(g).all())
               for g in tree.leaves(sharding.gather(grads)))


def test_train_main_on_a_virtual_mesh_checkpoints_gathered_params(
        tmp_path, capsys):
    """``launch.train --mesh 2,2 --virtual`` on the CPU: the reference's
    log lines, and a checkpoint equal bit for bit to the gathered
    params."""
    state, metrics = train.main([
        "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
        "--mesh", "2,2", "--virtual", "--checkpoint-every", "2",
        "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=granite-3-8b reduced=True device=cpu" in out
    assert "mesh={'data': 2, 'model': 2} virtual" in out
    assert "step     2  loss=" in out and out.strip().endswith("done.")
    assert isinstance(state.params, sharding.Placed)
    assert np.isfinite(float(metrics["loss"])) and int(state.step) == 2
    whole = sharding.gather(state.params)
    back, meta = load_checkpoint(tmp_path / "granite-3-8b_2.npz", whole)
    assert meta["step"] == 2
    for a, b in zip(tree.leaves(back), tree.leaves(whole)):
        assert torch.equal(a, b)
