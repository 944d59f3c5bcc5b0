"""The port's jamba, xlstm, pixtral and whisper on a (data, model) mesh
(``repro_torch.launch.mesh.LMMesh``; ``models.ssm``/``models.xlstm``'s
``*_shard`` functions, ``attention.cross_attention_shard``,
``sharding.read``, ``lm.*(mesh=)`` for the VLM and enc-dec inputs)
against the JAX package's LM on its 4-device host meshes, on the CPU.

One subprocess runs the JAX package with
``--xla_force_host_platform_device_count=4`` (its own, so that
``--dist loadfile`` may run it beside ``test_torch_lm_mesh.py``'s): for
each reduced fp32 family (jamba's MoE at capacity factor 1.0), its
jitted ``forward`` and ``serve_step`` logits on ``make_host_mesh`` (2, 2)
and (1, 4) (at ``model`` 4 the fused ``in_proj``/``up`` columns of a
device's ``x`` and ``z`` straddle two blocks), jamba's routing ids (a
``jax.debug.callback`` tagged by each layer's router), and one jitted
AdamW ``make_train_step`` on (2, 2).

Contracts (``test_torch_lm_mesh.py``'s):

* forward and every serve step within 1e-4 of the largest logit; jamba's
  routing ids and dropped assignments equal;
* the train step's loss and grad norm within 2e-5, its gathered
  gradients within 1e-4 of each leaf's largest, the moments within 1e-6,
  the params by Adam's first-step rule;
* every replica bit-equal after the step, the blocks ``local_shape``'s.

Port only: (4, 1) against the unmeshed port; the column read's gradient
landing on the block each column came from; the xLSTM states' replicas
bit-equal after decode steps; a VLM batch whose patch prefix is split
over data; the placement and bytes of every family, enc-dec decode
state included.
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
from repro.optim import optimizers as jopt
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import (lm_params_from_jax, lm_params_to_mesh,
                                 to_numpy, train_state_to_mesh)
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import LMMesh
from repro_torch.models import blocks, lm, moe, sharding, xlstm
from repro_torch.optim import optimizers as topt

from test_torch_lm_mesh import (LR, _adam_first_step_close, _Dispatches,
                                _local_shapes, _rel, _replicas_equal)

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-4                       # of the largest fp32 logit
ARCH = {"jamba": "jamba_1p5_large_398b", "xlstm": "xlstm_1p3b",
        "pixtral": "pixtral_12b", "whisper": "whisper_medium"}
MESHES = [(2, 2), (1, 4)]
TRAIN_MESH = (2, 2)
B = 4
# jamba: 128 tokens, 64 a data block (the JAX package's EP threshold);
# xlstm: two mLSTM chunks of 32
SEQ = {"jamba": 32, "xlstm": 40, "pixtral": 12, "whisper": 12}
ENC_LEN = 10
STEPS = 4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (``test_torch_lm_mesh.py``'s reasons: many
    small ops under several xdist workers, and bit-equal reruns)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    out = []
    for get in (jax_get_config, get_config):
        c = dataclasses.replace(get(ARCH[name], reduced=True),
                                param_dtype="float32",
                                compute_dtype="float32")
        if c.moe is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=1.0))
        out.append(c)
    return out


_JAX = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import make_host_mesh
from repro.models import lm, moe
from repro.optim import adamw
assert len(jax.devices()) == 4
ARCH, MESHES, TRAIN_MESH = %(arch)r, %(meshes)r, %(train)r
B, SEQ, ENC_LEN, STEPS, LR = %(b)r, %(seq)r, %(enc)r, %(steps)r, %(lr)r
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

for name, arch in ARCH.items():
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              param_dtype="float32", compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    p = lm.init_model(jax.random.PRNGKey(0), cfg)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(p)):
        out[f"{name}/param/{i}"] = np.asarray(leaf)
    rng = np.random.default_rng(len(name))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ[name])
                                    ).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["enc_frames"] = rng.normal(
            size=(B, ENC_LEN, cfg.d_model)).astype(np.float32)
    for k, v in batch.items():
        out[f"{name}/batch/{k}"] = v
    toks = batch["tokens"]
    fwd = jax.jit(lambda p, b: lm.forward(p, cfg, b, remat=False)[0])
    for shape in MESHES:
        key = f"{name}/{shape[0]}x{shape[1]}"
        mesh = make_host_mesh(*shape)
        assert mesh.devices.shape == shape
        with jax.sharding.set_mesh(mesh):
            if cfg.moe is not None:
                moe.route = recording_route
                routes.clear()
            out[f"{key}/forward"] = np.asarray(fwd(p, batch))
            moe.route = real_route
            step = jax.jit(lm.make_serve_step(cfg))
            st = lm.init_decode_state(p, cfg, B, STEPS,
                                      enc_frames=batch.get("enc_frames"))
            got = []
            for t in range(STEPS):
                lg, st = step(p, st, jnp.asarray(toks[:, t:t + 1]))
                got.append(np.asarray(lg))
            out[f"{key}/serve"] = np.stack(got)
            if cfg.moe is None:
                continue
            t_all = B * SEQ[name]
            e = cfg.moe.num_experts
            info = moe._ep_mesh_info(t_all, e)
            nb = info[2] if info is not None else moe._data_shards(t_all)
            out[f"{key}/path"] = np.asarray(0 if info is None else 1)
            cap = moe._capacity(t_all // nb, cfg.moe)
            stack = p["stack"]["super"]
            keys = sorted(k for k in stack if "router" in stack[k]["ff"])
            routers = [float(np.asarray(stack[k]["ff"]["router"])[0, 0, 0])
                       for k in keys]
            assert len(routes) == len(routers)
            for tag, ids in routes:
                layer = int(np.argmin(np.abs(np.asarray(routers) - tag)))
                out[f"{key}/ids/{layer}"] = ids
                out[f"{key}/dropped/{layer}"] = dropped(ids, e, cap, nb)
    # one AdamW step from (p, zero moments): its loss, grad norm, moments
    # and params (the step's gradient is m / (1 - b1))
    opt = adamw(LR)
    key = f"{name}/train"
    with jax.sharding.set_mesh(make_host_mesh(*TRAIN_MESH)):
        st, m = jax.jit(lm.make_train_step(cfg, opt))(
            lm.TrainState(p, opt.init(p), jnp.zeros((), jnp.int32)),
            {k: jnp.asarray(v) for k, v in batch.items()})
    for k_ in ("loss", "grad_norm"):
        out[f"{key}/{k_}"] = np.asarray(m[k_])
    for part in ("m", "v"):
        for i, leaf in enumerate(jax.tree_util.tree_leaves(
                st.opt_state[part])):
            out[f"{key}/{part}/{i}"] = np.asarray(leaf)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(st.params)):
        out[f"{key}/param/{i}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax4(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm_mesh_families") / "jax4.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = textwrap.dedent(_JAX) % dict(
        arch=ARCH, meshes=MESHES, train=TRAIN_MESH, b=B, seq=SEQ,
        enc=ENC_LEN, steps=STEPS, lr=LR)
    run = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                         timeout=600, capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(path))


def _jax_params(jax4, name, jcfg):
    treedef = jax.tree_util.tree_structure(jax_lm.abstract_params(jcfg))
    leaves = [jax4[f"{name}/param/{i}"] for i in range(treedef.num_leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _batch(jax4, name):
    return {k.rsplit("/", 1)[1]: torch.from_numpy(v)
            for k, v in jax4.items() if k.startswith(f"{name}/batch/")}


def _mesh(shape):
    return LMMesh.virtual("cpu", *shape)


def _moe_layers(cfg) -> int:
    return sum(s.ff == "moe" for s in cfg.layout())


# ---------------------------------------------------------- against JAX ----

@pytest.mark.parametrize("name,shape", [(n, s) for n in ARCH
                                        for s in MESHES],
                         ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_forward_and_serve_match_the_jax_mesh(jax4, name, shape,
                                              monkeypatch):
    jcfg, tcfg = _cfgs(name)
    mesh = _mesh(shape)
    tp = lm_params_to_mesh(jax.device_get(_jax_params(jax4, name, jcfg)),
                           tcfg, mesh)
    batch = _batch(jax4, name)
    key = f"{name}/{shape[0]}x{shape[1]}"
    rec = _Dispatches(monkeypatch) if tcfg.moe is not None else None
    moe.reset_dispatch_counts()
    got, _ = lm.forward(tp, tcfg, batch, mesh=mesh)
    assert got.shape == (B, SEQ[name], tcfg.vocab_size)
    assert _rel(got, jax4[f"{key}/forward"]) <= TOL
    if rec is not None:
        n_moe = _moe_layers(tcfg)
        ep = bool(jax4[f"{key}/path"])
        assert moe.dispatch_counts()["ep" if ep else "blocked"] == n_moe
        nb = mesh.n_rows if ep else moe.n_blocks(B * SEQ[name], mesh.n_rows)
        layers_ = rec.layers(mesh, ep, nb)
        assert len(layers_) == n_moe
        for i, (ids, dropped) in enumerate(layers_):
            np.testing.assert_array_equal(ids.numpy(),
                                          jax4[f"{key}/ids/{i}"])
            np.testing.assert_array_equal(dropped,
                                          jax4[f"{key}/dropped/{i}"])
        monkeypatch.undo()

    last = lm.prefill(tp, tcfg, batch, mesh=mesh)
    assert _rel(last, jax4[f"{key}/forward"][:, -1]) <= TOL
    step = lm.make_serve_step(tcfg, mesh)
    st = lm.init_decode_state(tp, tcfg, B, STEPS,
                              enc_frames=batch.get("enc_frames"), mesh=mesh)
    for t in range(STEPS):
        lg, st = step(tp, st, batch["tokens"][:, t:t + 1])
        assert _rel(lg, jax4[f"{key}/serve"][t]) <= TOL
    assert st.pos == STEPS


@pytest.mark.parametrize("name", list(ARCH))
def test_train_step_matches_the_jax_mesh(jax4, name):
    """One AdamW step on (2, 2) from the JAX package's state: loss and grad
    norm at 2e-5, the gathered gradients of ``value_and_grad(mesh=)`` at
    1e-4 of each leaf's largest, m and v at 1e-6, the params by Adam's
    first-step rule; then every replica bit-equal, every block
    ``local_shape``'s.  The rule's exact zeros are those of both
    gradients: where the JAX package's is exactly 0 and the port's is
    summation noise (xlstm's ``b_gates``, whisper's ``wk``; the unmeshed
    port's step too), ``g / (|g| + eps)`` moves the parameter by a share
    of lr, and the step's own bound holds there."""
    jcfg, tcfg = _cfgs(name)
    jp = _jax_params(jax4, name, jcfg)
    js = jax_lm.TrainState(jp, jopt.adamw(LR).init(jp),
                           np.zeros((), np.int32))
    mesh = _mesh(TRAIN_MESH)
    ts = train_state_to_mesh(jax.device_get(js), tcfg, mesh)
    whole = lm_params_from_jax(jax.device_get(jp), "cpu")
    batch = _batch(jax4, name)
    key = f"{name}/train"
    _, _, grads = lm.value_and_grad(ts.params, tcfg, batch, mesh=mesh)
    _replicas_equal(grads)
    b1 = np.float32(0.1)
    for i, g in enumerate(tree.leaves(to_numpy(sharding.gather(grads)))):
        want = jax4[f"{key}/m/{i}"] / b1
        assert np.abs(g - want).max() <= 1e-4 * max(np.abs(want).max(),
                                                    1e-30)
    p0 = tree.leaves(to_numpy(whole))
    ts2, tm = lm.make_train_step(tcfg, topt.adamw(LR), mesh=mesh)(
        ts, batch)
    for k in ("loss", "grad_norm"):
        want = float(jax4[f"{key}/{k}"])
        assert abs(float(tm[k]) - want) <= 2e-5 * max(1.0, abs(want)), k
    opt = sharding.gather(ts2.opt_state)
    for part in ("m", "v"):
        for i, got in enumerate(tree.leaves(to_numpy(opt[part]))):
            np.testing.assert_allclose(got, jax4[f"{key}/{part}/{i}"],
                                       rtol=0, atol=1e-6)
    _adam_first_step_close(
        p0, tree.leaves(to_numpy(sharding.gather(ts2.params))),
        [jax4[f"{key}/param/{i}"] for i in range(len(p0))],
        [jax4[f"{key}/m/{i}"] for i in range(len(p0))],
        tree.leaves(to_numpy(opt["m"])))
    assert _replicas_equal(ts2.params) + _replicas_equal(ts2.opt_state) > 0
    _local_shapes(ts2.params, whole)


# ------------------------------------------------------------ port only ----

def _family_batch(cfg, seed, b=B, s=12):
    gen = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen)}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.randn(b, cfg.num_patch_tokens,
                                          cfg.d_model, generator=gen)
    if cfg.is_encdec:
        out["enc_frames"] = torch.randn(b, ENC_LEN, cfg.d_model,
                                        generator=gen)
    return out


@pytest.mark.parametrize("name", list(ARCH))
def test_four_by_one_matches_unmeshed(name):
    """On (4, 1) every device holds whole heads and channels: the forward,
    the serve steps and the gathered gradients within 1e-5 of the
    unmeshed port's (jamba's experts given room for every token, so the
    4 data blocks drop nothing)."""
    _, cfg = _cfgs(name)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    params = lm.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = _family_batch(cfg, 2)
    mesh = _mesh((4, 1))
    placed = lm.place_params(params, cfg, mesh)
    want, _ = lm.forward(params, cfg, batch)
    got, _ = lm.forward(placed, cfg, batch, mesh=mesh)
    assert _rel(got, want) <= 1e-5
    frames = batch.get("enc_frames")
    st = lm.init_decode_state(placed, cfg, B, STEPS, enc_frames=frames,
                              mesh=mesh)
    st0 = lm.init_decode_state(params, cfg, B, STEPS, enc_frames=frames)
    step, step0 = lm.make_serve_step(cfg, mesh), lm.make_serve_step(cfg)
    for t in range(STEPS):
        a, st = step(placed, st, batch["tokens"][:, t:t + 1])
        b, st0 = step0(params, st0, batch["tokens"][:, t:t + 1])
        assert _rel(a, b) <= 1e-5
    l1, _, g1 = lm.value_and_grad(placed, cfg, batch, mesh=mesh)
    l0, _, g0 = lm.value_and_grad(params, cfg, batch)
    assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
    for a, b in zip(tree.leaves(sharding.gather(g1)), tree.leaves(g0)):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("name", ["jamba", "pixtral", "whisper"])
def test_meshed_bf16_gradients_as_close_to_fp32_as_unmeshed(name):
    """In bf16 the (2, 2) mesh's gathered gradients lie, leaf by leaf in L2
    norm, within 2x the unmeshed bf16 gradients' distance from the fp32
    gradients of the same weights: the mesh's rounding is of the size of
    the unmeshed path's own, so the two bf16 paths differ by about as
    much as each differs from fp32 (what the card's meshed gradients are
    held to).  A missing sum or a misplaced transpose would put a leaf
    O(1) away.  xlstm is held in fp32 on the card, so it is left out."""
    _, c32 = _cfgs(name)
    if c32.moe is not None:
        c32 = dataclasses.replace(c32, moe=dataclasses.replace(
            c32.moe, capacity_factor=float(c32.moe.num_experts)))
    cfg = dataclasses.replace(c32, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = lm.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = _family_batch(cfg, 2)
    bf16 = {k: v.bfloat16() if v.is_floating_point() else v
            for k, v in batch.items()}
    _, _, truth = lm.value_and_grad(
        tree.tree_map(lambda t: t.float(), params), c32, batch)
    _, _, plain = lm.value_and_grad(params, cfg, bf16)
    mesh = _mesh((2, 2))
    _, _, got = lm.value_and_grad(lm.place_params(params, cfg, mesh), cfg,
                                  bf16, mesh=mesh)

    def dist(a, b):
        return float((a.float() - b).norm() / b.norm())

    for (n, g), p, t in zip(tree.named_leaves(sharding.gather(got)),
                            tree.leaves(plain), tree.leaves(truth)):
        assert dist(g, t) <= 2 * dist(p, t), "/".join(n)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (1, 8)])
def test_column_read_gradient_lands_on_its_blocks(shape):
    """``sharding.read`` of a fused (d, 2 di) leaf under ("embed",
    "inner"): device k's ``x`` and ``z`` columns, at ``model`` 2 (each
    half one block), 4 and 8 (each half straddling blocks): the values
    are those columns of the whole leaf, and the gradient of every
    device's read, summed by ``reduce_replicas``, is the whole leaf's
    gradient of the same uses, each column's on the block that holds
    it."""
    mesh = _mesh(shape)
    d, di = 8, 16
    w = torch.randn(d, 2 * di, generator=torch.Generator().manual_seed(0))
    sp = sharding.spec("embed", "inner", shape=w.shape, mesh=mesh)
    placed = sharding.place({"w": w}, {"w": sp}, mesh)
    leaves = [sh["w"].requires_grad_(True) for sh in placed.shards]
    whole = w.clone().requires_grad_(True)
    gen = torch.Generator().manual_seed(1)
    total, want = 0.0, 0.0
    for k in range(mesh.size):
        lo, hi = sharding.block_range("model", mesh, k, di)
        cols = [(lo, hi), (di + lo, di + hi)]
        got = sharding.read(leaves, sp, mesh, k, [None, cols])
        ref = torch.cat([whole[:, lo:hi], whole[:, di + lo:di + hi]], 1)
        assert torch.equal(got.detach(), ref.detach())
        ct = torch.randn(got.shape, generator=gen)
        total = total + (got * ct).sum()
        want = want + (ref * ct).sum()
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    g = sharding.gather(sharding.reduce_replicas(sharding.Placed(
        mesh, {"w": sp}, tuple({"w": torch.zeros_like(t) if gi is None
                                else gi} for t, gi in zip(leaves, grads)))))
    gw, = torch.autograd.grad(want, [whole])
    assert torch.equal(g["w"], gw)
    # the region of device k's own block is the block itself
    own = [sharding.block_range(e, mesh, 0, n) for e, n in zip(sp, w.shape)]
    assert sharding.read(leaves, sp, mesh, 0, [[r] for r in own]) is \
        leaves[0]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_xlstm_state_replicas_are_bit_equal_after_decode(shape):
    """After 4 meshed decode steps every device of a row holds the same
    mLSTM and sLSTM states, bit for bit (each head's from the device that
    ran it), within 1e-5 of the unmeshed states, in ``local_shape``
    blocks."""
    _, cfg = _cfgs("xlstm")
    params = lm.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    mesh = _mesh(shape)
    placed = lm.place_params(params, cfg, mesh)
    st = lm.init_decode_state(placed, cfg, B, STEPS, mesh=mesh)
    st0 = lm.init_decode_state(params, cfg, B, STEPS)
    step, step0 = lm.make_serve_step(cfg, mesh), lm.make_serve_step(cfg)
    toks = _family_batch(cfg, 4)["tokens"]
    for t in range(STEPS):
        _, st = step(placed, st, toks[:, t:t + 1])
        _, st0 = step0(params, st0, toks[:, t:t + 1])
    assert _replicas_equal(st.stack) > 0
    kinds = {type(v) for v in st.stack.shards[0]["super"].values()}
    assert kinds == {xlstm.MLSTMState, xlstm.SLSTMState}
    whole = sharding.gather(st.stack)
    for a, b in zip(tree.named_values(whole), tree.named_values(st0.stack)):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1.0)
    _local_shapes(st.stack, st0.stack)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_vlm_patch_prefix_is_split_over_data(shape):
    """A pixtral batch whose rows carry different patch embeddings: each
    data row of the mesh prefixes its own rows' patches, so the meshed
    forward, loss and prefill equal the unmeshed ones (within 1e-5), and
    swapping two rows' patches swaps their logits."""
    _, cfg = _cfgs("pixtral")
    params = lm.init_model(cfg, torch.Generator().manual_seed(5), "cpu")
    batch = _family_batch(cfg, 6)
    mesh = _mesh(shape)
    placed = lm.place_params(params, cfg, mesh)
    spec = blocks.MeshBatch.of(mesh, B, 1, cfg.d_model).spec
    assert spec[0] == "data"
    want, _ = lm.forward(params, cfg, batch)
    got, _ = lm.forward(placed, cfg, batch, mesh=mesh)
    assert got.shape == (B, 12, cfg.vocab_size) and _rel(got, want) <= 1e-5
    l1, _ = lm.loss_fn(placed, cfg, batch, mesh=mesh)
    l0, _ = lm.loss_fn(params, cfg, batch)
    assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
    last = lm.prefill(placed, cfg, batch, mesh=mesh)
    assert _rel(last, want[:, -1]) <= 1e-5
    swapped = dict(batch, patch_embeds=batch["patch_embeds"][[3, 1, 2, 0]],
                   tokens=batch["tokens"][[3, 1, 2, 0]])
    again, _ = lm.forward(placed, cfg, swapped, mesh=mesh)
    assert _rel(again[[3, 1, 2, 0]], got) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("name", list(ARCH))
def test_placed_blocks_and_state_bytes(name, shape):
    """Every family's placed blocks have ``local_shape``'s shapes and each
    device's bytes its count, the decode state's too (whisper's encoder
    rows under ("batch", "seq", None) included); ``gather`` of the
    placement is exact."""
    _, cfg = _cfgs(name)
    mesh = _mesh(shape)
    params = lm.init_model(cfg, torch.Generator().manual_seed(7), "cpu")
    placed = lm.place_params(params, cfg, mesh)
    _local_shapes(placed, params)
    assert sharding.device_bytes(placed) == [sharding.local_bytes(
        params, placed.specs, mesh)] * mesh.size
    for a, b in zip(tree.leaves(sharding.gather(placed)),
                    tree.leaves(params)):
        assert torch.equal(a, b)
    frames = _family_batch(cfg, 8).get("enc_frames")
    st = lm.init_decode_state(placed, cfg, B, STEPS, enc_frames=frames,
                              mesh=mesh)
    shapes = lm.abstract_decode_state(cfg, B, STEPS, ENC_LEN)
    _local_shapes(st.stack, shapes.stack)
    assert sharding.device_bytes(st.stack) == [sharding.local_bytes(
        shapes.stack, st.stack.specs, mesh)] * mesh.size
    if cfg.is_encdec:
        assert st.enc.specs == lm.decode_state_pspecs(cfg, shapes,
                                                      mesh).enc
        assert sharding.device_bytes(st.enc) == [sharding.local_bytes(
            shapes.enc, st.enc.specs, mesh)] * mesh.size
        want = lm.init_decode_state(params, cfg, B, STEPS,
                                    enc_frames=frames).enc
        assert _rel(sharding.unsplit(list(st.enc.shards), st.enc.specs,
                                     mesh), want) <= 1e-5
    else:
        assert st.enc is None


@pytest.mark.parametrize("name", list(ARCH))
def test_serve_and_train_drivers_on_a_virtual_mesh(name, tmp_path, capsys):
    """``launch.serve`` and ``launch.train`` with ``--mesh 2,2 --virtual``
    run every family on the CPU: the reference's log lines, the served
    request's first tokens those of the unmeshed run (the same seeded
    request), a finite loss and the gathered parameters checkpointed."""
    arch = ARCH[name]
    seq = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--steps", "2", "--sample", "greedy", "--mesh", "2,2",
                      "--virtual"])
    assert "mesh=(2, 2) virtual" in capsys.readouterr().out
    one = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--steps", "2", "--sample", "greedy"])
    capsys.readouterr()
    assert seq.shape == (2, 3) and torch.equal(seq[:, 0], one[:, 0])
    state, metrics = train.main([
        "--arch", arch, "--steps", "1", "--batch", "2", "--seq", "16",
        "--device", "cpu", "--mesh", "2,2", "--virtual",
        "--checkpoint-every", "1", "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 2} virtual" in out
    assert out.strip().endswith("done.")
    assert isinstance(state.params, sharding.Placed)
    assert np.isfinite(float(metrics["loss"])) and int(state.step) == 1
    assert len(list(tmp_path.glob("*_1.npz"))) == 1
