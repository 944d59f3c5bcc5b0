"""FedDD across pods on a transformer, held against the JAX package on the
CPU (``repro.launch.federated``).

* ``pod_telemetry`` and the k bucket equal.
* One pod in process: the port's round against the JAX package's
  ``make_round_fn`` on one CPU device, params at 2e-5 (fp32); one pod's
  exchange returns its own local update.
* Four virtual pods against the JAX package's 4-device round, run in one
  subprocess under ``--xla_force_host_platform_device_count=4``: fp32
  params at 2e-5 and the kept channel sets equal, pod by pod and leaf by
  leaf (the port's as ``compact_topk`` picks them inside
  ``sparse_allgather_mean``); bf16 losses within 3e-2 (the local SGD
  steps round bf16 gradients in each framework's order).
* The bf16 Eq. (20) mask contract: on the same bf16 leaves (the JAX
  pods' own local updates) the port's float32 scores keep the channels
  the JAX package's bf16 scores keep, except channels whose float32
  score lies within 2^-7 of the k-th (one bf16 ulp: two scores that
  close can round to one bf16 value, and ``lax.top_k`` then keeps the
  lower id).
* ``python -m repro_torch.launch.federated`` and ``python -m
  repro_torch.federated_pods`` (FedDD and ``--dense``) on the CPU.
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
from repro.launch import federated as jax_fed
from repro.models import lm as jax_lm
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.importance import channel_importance
from repro_torch.core import sparse_collective
from repro_torch.core.sparse_collective import compact_topk
from repro_torch import federated_pods
from repro_torch.launch import federated
from repro_torch.models import lm

SRC = str(Path(__file__).resolve().parents[1] / "src")
LR, STEPS = 3e-2, 2
D = np.array([0.3, 0.5, 0.55, 0.75], np.float32)
MASK_REL = 2.0 ** -7


def _cfg(get, dtype):
    cfg = get("granite_3_8b", reduced=True)
    return dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                               num_heads=4, num_kv_heads=2, head_dim=16,
                               vocab_size=97, param_dtype=dtype,
                               compute_dtype=dtype)


def _tokens(n):
    rng = np.random.default_rng(0)
    return rng.integers(0, 97, (n, 2, 12)).astype(np.int32)


def test_telemetry_and_bucket_match_jax():
    a, b = federated.pod_telemetry(4, 1e6, 3), jax_fed.pod_telemetry(4, 1e6,
                                                                     3)
    for f in dataclasses.fields(a):
        assert np.array_equal(getattr(a, f.name), getattr(b, f.name))
    d = np.array([0.41, 0.8, 0.62])
    assert federated.k_bucket(d) == float(np.ceil((1.0 - d.min()) * 16) / 16)
    assert federated.keep_counts(100, D) == [
        int(np.asarray(jnp.ceil(100 * (1.0 - jnp.asarray(x))))) for x in D]


def test_one_pod_round_matches_jax_in_process():
    """P = 1: the JAX round on this process's one CPU device."""
    jcfg, tcfg = _cfg(jax_get_config, "float32"), _cfg(get_config,
                                                       "float32")
    jp = jax_lm.init_model(jax.random.PRNGKey(0), jcfg)
    toks = _tokens(1)
    mesh = jax.make_mesh((1,), ("pod",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    k_frac = 0.75
    want, wl = jax_fed.make_round_fn(jcfg, mesh, LR, STEPS, k_frac)(
        jax.tree_util.tree_map(lambda t: t[None], jp), jnp.asarray(toks),
        jnp.asarray(D[:1]))
    pm = federated.pod_mesh(1, "cpu")
    init = lm_params_from_jax(jax.device_get(jp), "cpu")
    got, gl = federated.make_round_fn(tcfg, pm, LR, STEPS, k_frac)(
        [init], [torch.from_numpy(toks[0])], D[:1])
    assert abs(float(gl[0]) - float(wl[0])) <= 2e-5
    for g, w in zip(tree.leaves(got[0]), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[0], rtol=0,
                                   atol=2e-5)
    # one pod: its kept channels average to themselves, the rest stay local
    own, _ = federated.local_sgd(init, tcfg, torch.from_numpy(toks[0]), LR,
                                 STEPS)
    for g, o in zip(tree.leaves(got[0]), tree.leaves(own)):
        assert torch.equal(g, o)


def _kept_by_leaf(picked, leaves, k_frac, n_pods):
    """Per leaf, ``None`` (dense) or each pod's kept channel ids: the
    indices ``compact_topk`` picked inside ``sparse_allgather_mean`` (in
    leaf, then pod order), cut to each pod's keep count."""
    picked, kept = iter(picked), []
    for leaf in leaves:
        if leaf.ndim <= 1:
            kept.append(None)
            continue
        c = leaf.shape[-1]
        k = max(1, int(np.ceil(c * k_frac)))
        kept.append([next(picked)[:min(k, kl)]
                     for kl in federated.keep_counts(c, D[:n_pods])])
    assert next(picked, None) is None
    return kept


_JAX_FOUR = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.importance import channel_importance
from repro.launch.federated import make_round_fn
from repro.models import lm
n, lr, steps = 4, %(lr)r, %(steps)r
d = np.array(%(d)r, np.float32)
assert len(jax.devices()) == n
mesh = jax.make_mesh((n,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
toks = np.random.default_rng(0).integers(0, 97, (n, 2, 12)).astype(np.int32)
k_frac = float(np.ceil((1.0 - d.min()) * 16) / 16)
f32 = lambda t: np.asarray(t.astype(jnp.float32))
for dtype, path in zip(("float32", "bfloat16"), sys.argv[1:]):
    cfg = dataclasses.replace(
        get_config("granite_3_8b", reduced=True), num_layers=2, d_model=64,
        d_ff=128, num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=97,
        param_dtype=dtype, compute_dtype=dtype)
    params = lm.init_model(jax.random.PRNGKey(0), cfg)
    out, lvec = make_round_fn(cfg, mesh, lr, steps, k_frac)(
        jax.tree_util.tree_map(
            lambda t: jnp.broadcast_to(t[None], (n,) + t.shape), params),
        jnp.asarray(toks), jnp.asarray(d))
    res = {"loss": np.asarray(lvec)}
    for i, l in enumerate(jax.tree_util.tree_leaves(out)):
        res[f"out{i}"] = f32(l)
    for i, l in enumerate(jax.tree_util.tree_leaves(params)):
        res[f"init{i}"] = f32(l)
    # each pod's local update and kept channels, as the round body makes them
    grad = jax.jit(jax.grad(
        lambda p, t: lm.loss_fn(p, cfg, {"tokens": t}, remat=False)[0]))
    for pod in range(n):
        p = params
        for _ in range(steps):
            g = grad(p, jnp.asarray(toks[pod]))
            p = jax.tree_util.tree_map(
                lambda a, b: (a.astype(jnp.float32)
                              - lr * b.astype(jnp.float32)).astype(a.dtype),
                p, g)
        for i, (o, w) in enumerate(zip(jax.tree_util.tree_leaves(params),
                                       jax.tree_util.tree_leaves(p))):
            if w.ndim <= 1:
                continue
            c = w.shape[-1]
            s = channel_importance(jnp.moveaxis(o, -1, 0).reshape(c, -1),
                                   jnp.moveaxis(w, -1, 0).reshape(c, -1),
                                   channel_axis=0)
            k = max(1, int(np.ceil(c * k_frac)))
            kn = int(jnp.ceil(c * (1.0 - jnp.asarray(d[pod]))))
            res[f"kept{pod}_{i}"] = np.asarray(
                jax.lax.top_k(s, k)[1])[:min(kn, k)]
            res[f"new{pod}_{i}"] = f32(w)
    np.savez(path, **res)
""" % dict(lr=LR, steps=STEPS, d=D.tolist())


@pytest.fixture(scope="module")
def jax_four(tmp_path_factory):
    """The JAX package's 4-device round, fp32 and bf16, in one
    subprocess."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    base = tmp_path_factory.mktemp("jax4")
    paths = [base / f"{dtype}.npz" for dtype in ("float32", "bfloat16")]
    subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_FOUR)]
                   + [str(p) for p in paths], env=env, check=True,
                   timeout=300, capture_output=True)
    return {dtype: dict(np.load(p))
            for dtype, p in zip(("float32", "bfloat16"), paths)}


def _port_round(want, dtype, monkeypatch):
    cfg = _cfg(get_config, dtype)
    gen = torch.Generator().manual_seed(0)
    leaves, td = tree.flatten(lm.init_model(cfg, gen, "cpu"))
    init = tree.unflatten(td, [torch.from_numpy(want[f"init{i}"]).to(l.dtype)
                               for i, l in enumerate(leaves)])
    mesh = federated.pod_mesh(4, "cpu")
    assert mesh.num_shards == 4 and len(set(mesh.devices)) == 1
    k_frac = federated.k_bucket(D)
    picked = []

    def recording(values, scores, k):
        compact, idx = compact_topk(values, scores, k)
        picked.append(idx)
        return compact, idx

    monkeypatch.setattr(sparse_collective, "compact_topk", recording)
    out, losses = federated.make_round_fn(cfg, mesh, LR, STEPS, k_frac)(
        [tree.tree_map(torch.clone, init) for _ in range(4)],
        [torch.from_numpy(t) for t in _tokens(4)], D)
    return out, losses, _kept_by_leaf(picked, leaves, k_frac, 4), len(leaves)


def test_four_virtual_pods_match_jax_four_devices_fp32(jax_four,
                                                       monkeypatch):
    want = jax_four["float32"]
    out, losses, kept, n_leaves = _port_round(want, "float32", monkeypatch)
    np.testing.assert_allclose(losses.numpy(), want["loss"], rtol=0,
                               atol=2e-5)
    for i in range(n_leaves):
        got = np.stack([tree.leaves(o)[i].numpy() for o in out])
        np.testing.assert_allclose(got, want[f"out{i}"], rtol=0, atol=2e-5)
        if kept[i] is None:
            assert f"kept0_{i}" not in want
            continue
        for pod in range(4):
            assert sorted(kept[i][pod].tolist()) == sorted(
                want[f"kept{pod}_{i}"].tolist()), (i, pod)
    assert sum(k is not None for k in kept) == n_leaves - 1   # final norm


def test_four_virtual_pods_bf16_and_the_mask_contract(jax_four,
                                                     monkeypatch):
    want = jax_four["bfloat16"]
    out, losses, _, n_leaves = _port_round(want, "bfloat16", monkeypatch)
    np.testing.assert_allclose(losses.numpy(), want["loss"], rtol=3e-2)
    assert all(bool(torch.isfinite(t.float()).all()) for o in out
               for t in tree.leaves(o))
    k_frac = federated.k_bucket(D)
    cfg = _cfg(get_config, "bfloat16")
    dts = [l.dtype for l in tree.leaves(lm.init_model(
        cfg, torch.Generator().manual_seed(0), "cpu"))]
    flips = checked = 0
    for key in want:
        if not key.startswith("kept"):
            continue
        pod, i = map(int, key[4:].split("_"))
        old = torch.from_numpy(want[f"init{i}"]).to(dts[i])
        new = torch.from_numpy(want[f"new{pod}_{i}"]).to(dts[i])
        s = channel_importance(old, new, channel_axis=-1).numpy()
        c = s.shape[0]
        kl = min(max(1, int(np.ceil(c * k_frac))),
                 federated.keep_counts(c, D[pod:pod + 1])[0])
        got = set(np.argsort(-s, kind="stable")[:kl].tolist())
        kth = np.sort(s)[::-1][kl - 1]
        for ch in got ^ set(want[key].tolist()):
            assert abs(s[ch] - kth) <= MASK_REL * kth, (key, ch)
            flips += 1
        checked += 1
    assert checked == 4 * (n_leaves - 1) and flips < checked


def test_federated_clis_on_cpu(capsys):
    """The drivers' log lines on two virtual CPU pods; the pods example's
    FedDD and --dense runs start from one state (equal first losses)."""
    pods, out = federated.main(["--pods", "2", "--rounds", "2", "--device",
                                "cpu"])
    log = capsys.readouterr().out
    assert "round 1: D=[" in log and "k_frac=" in log and "t_server=" in log
    assert log.strip().endswith("done.") and len(pods) == 2
    assert all(np.isfinite(r["losses"]).all() for r in out)
    _, sparse = federated_pods.main(["--pods", "2", "--rounds", "1",
                                     "--device", "cpu"])
    _, dense = federated_pods.main(["--pods", "2", "--rounds", "1",
                                    "--dense", "--device", "cpu"])
    log = capsys.readouterr().out
    assert "mode=feddd" in log and "mode=dense" in log
    assert "round   1  mean_loss=" in log
    assert sparse == dense and all(np.isfinite(sparse))
