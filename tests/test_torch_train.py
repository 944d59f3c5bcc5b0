"""The port's LM train step, held against the JAX package on the CPU.

* The optimizers (sgd with and without momentum, adam, adamw, adafactor)
  against ``repro.optim`` for 3 steps on the same numpy gradients: states
  and updated params leaf for leaf at 1e-6.
* ``make_lm_dataset``, ``PackedLMBatcher`` and ``BatchIterator``
  bit-equal to ``repro.data``.
* ``_sdpa_chunked`` (the chunked online-softmax route a training step
  takes at ``S >= FLASH_MIN_SEQ``): value and q/k/v gradients against the
  JAX package's at S = 8192 and at a padded S, causal and local; the
  flash wrapper raises on inputs that require grad, and the training
  route never launches it.
* ``loss_fn`` and its gradients against ``jax.value_and_grad`` for the
  reduced granite-3-8b and qwen3-moe-30b-a3b: fp32 at 2e-5; bf16 within
  3e-2 of the largest |gradient| of the leaf (the two frameworks round
  bf16 intermediates at different places; LM_TOL of tests/test_torch_lm).
* ``make_train_step`` against the JAX package's at microbatches 1 and 4,
  remat on and off, from one state carried by ``train_state_from_jax``:
  adafactor for 3 steps (loss and params at 2e-5, states leaf for leaf),
  and one AdamW step (loss at 2e-5, moments leaf for leaf at 1e-6, params
  at 2e-5 wherever g = 0 or |g| >= 1e-6; see
  ``test_train_step_adamw_matches_jax``).
* ``python -m repro_torch.launch.train`` on the CPU, with a checkpoint.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import PackedLMBatcher as JaxPacked
from repro.data import make_lm_dataset as jax_make_lm_dataset
from repro.data.pipeline import BatchIterator as JaxBatchIterator
from repro.models import attention as jax_attn
from repro.models import lm as jax_lm
from repro.optim import optimizers as jopt
from repro_torch import tree
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import (lm_params_from_jax, train_state_from_jax,
                                 train_state_to_numpy, to_numpy)
from repro_torch.data import (BatchIterator, PackedLMBatcher,
                              make_lm_dataset)
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import specs, train
from repro_torch.models import attention, lm
from repro_torch.optim import optimizers as topt

from torch_parity import np32

ARCHS = ["granite_3_8b", "qwen3_moe_30b_a3b"]


def _cfgs(arch, dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jax_get_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


def _tokens(cfg, seed, shape=(4, 16)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _close_trees(got, want, tol, what):
    g_l = tree.leaves(to_numpy(got))
    w_l = jax.tree_util.tree_leaves(jax.device_get(want))
    assert len(g_l) == len(w_l), what
    for a, b in zip(g_l, w_l):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=0,
                                   atol=tol, err_msg=what)


# ------------------------------------------------------------ optimizers ---

OPTS = {
    "sgd": (lambda m: m.sgd(0.1)),
    "sgd_momentum": (lambda m: m.sgd(0.1, momentum=0.9)),
    "adam": (lambda m: m.adam(1e-2)),
    "adamw": (lambda m: m.adamw(1e-2)),
    "adafactor": (lambda m: m.adafactor(1e-2)),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizers_match_jax(name):
    """3 steps on the same gradients: states and params leaf for leaf at
    1e-6 (rank-1, rank-2 and stacked rank-3 leaves; adafactor factors the
    rank-2+ ones)."""
    rng = np.random.default_rng(0)
    shapes = {"b": (7,), "w": (5, 6), "s": {"k": (3, 4, 8)}}
    params = tree.tree_map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes)
    grads = [tree.tree_map(lambda s: rng.normal(size=s).astype(np.float32),
                           shapes) for _ in range(3)]
    jo, to = OPTS[name](jopt), OPTS[name](topt)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree.tree_map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(tree.tree_map(torch.from_numpy, g), ts, tp)
        tp = topt.apply_updates(tp, tu)
    _close_trees(ts, js, 1e-6, f"{name} state")
    _close_trees(tp, jp, 1e-6, f"{name} params")
    assert int(ts["step"]) == 3 and ts["step"].dtype == torch.int32


def test_optimizer_moments_are_fp32_and_updates_cast_back():
    """bf16 params: fp32 moments, the update added in fp32 and cast back
    to bf16 (bit-equal to the JAX package's cast)."""
    rng = np.random.default_rng(1)
    p = rng.normal(size=(4, 8)).astype(np.float32)
    g = rng.normal(size=(4, 8)).astype(np.float32)
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p).to(torch.bfloat16)}
    jo, to = jopt.adamw(1e-2), topt.adamw(1e-2)
    js, ts = jo.init(jp), to.init(tp)
    assert ts["m"]["w"].dtype == torch.float32
    ju, js = jo.update({"w": jnp.asarray(g, jnp.bfloat16)}, js, jp)
    tu, ts = to.update({"w": torch.from_numpy(g).to(torch.bfloat16)}, ts, tp)
    got = topt.apply_updates(tp, tu)["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np32(got),
                                  np32(jopt.apply_updates(jp, ju)["w"]))


# ------------------------------------------------------------------ data ---

def test_lm_dataset_and_batchers_bit_equal():
    want = jax_make_lm_dataset(vocab_size=515, num_tokens=20_000, seed=3)
    got = make_lm_dataset(vocab_size=515, num_tokens=20_000, seed=3)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    jb, tb = JaxPacked(want, 32, 4, seed=5), PackedLMBatcher(got, 32, 4,
                                                             seed=5)
    for step in (0, 1, 17):
        assert np.array_equal(tb.batch(step)["tokens"],
                              jb.batch(step)["tokens"])
    x = np.arange(50 * 3, dtype=np.float32).reshape(50, 3)
    y = np.arange(50, dtype=np.int32)
    for e in (0, 2):
        for (a, b), (c, d) in zip(BatchIterator(x, y, 8, seed=4).epoch(e),
                                  JaxBatchIterator(x, y, 8, seed=4).epoch(e)):
            assert np.array_equal(a, c) and np.array_equal(b, d)
    assert BatchIterator(x, y, 8).steps_per_epoch() == 6


# ------------------------------------------------------- chunked attention -

@pytest.mark.parametrize("s,mode,window", [(8192, "full", 0),
                                           (8192, "local", 1000),
                                           (2048 + 300, "full", 0),
                                           (2048 + 300, "local", 700)])
def test_sdpa_chunked_value_and_grads_match_jax(s, mode, window):
    """The training route at S >= FLASH_MIN_SEQ and at a padded length:
    output and q/k/v cotangents at 3e-5 (fp32, small widths)."""
    b, h, hkv, hd = 1, 2, 1, 8
    rng = np.random.default_rng(s + window)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    ct = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jax_attn._sdpa_chunked(
        *a, mode=mode, window=window), *map(jnp.asarray, (q, k, v)))
    wq, wk, wv = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = attention._sdpa_chunked(tq, tk, tv, mode=mode, window=window)
    got.backward(torch.from_numpy(ct))
    for g, w in ((got, want), (tq.grad, wq), (tk.grad, wk), (tv.grad, wv)):
        np.testing.assert_allclose(np32(g), np.asarray(w), rtol=3e-5,
                                   atol=3e-5)


def test_training_takes_the_chunked_route_and_flash_refuses_grad(
        monkeypatch):
    """With grad, self_attention at S >= FLASH_MIN_SEQ runs _sdpa_chunked
    and never the flash wrapper; without it, the flash wrapper (its plain
    version on the CPU); the wrapper raises on inputs that require grad,
    whatever the device, and under inference_mode it does not."""
    cfg = get_config("granite_3_8b", reduced=True)
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 64)
    monkeypatch.setattr(attention, "FLASH_CHUNK", 32)
    calls = []
    real = flash_ops.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention", counting)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_model(cfg, gen, "cpu")
    p_mixer = tree.tree_map(lambda t: t[0].clone().requires_grad_(True),
                            params["stack"]["super"]["p0"]["mixer"])
    x = torch.randn(1, 80, cfg.d_model, generator=gen)
    y = attention.self_attention(p_mixer, cfg, x, mode="full")
    y.sum().backward()
    assert not calls and p_mixer["wq"].grad is not None
    with torch.inference_mode():
        y2 = attention.self_attention(
            tree.tree_map(lambda t: t.detach(), p_mixer), cfg, x,
            mode="full")
    assert calls == [1]
    torch.testing.assert_close(y2, y.detach(), rtol=1e-5, atol=1e-5)
    q = torch.randn(1, 16, 2, 16, requires_grad=True)
    kv = torch.randn(1, 16, 1, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        real(q, kv, kv)
    with torch.no_grad():
        assert real(q, kv, kv).shape == q.shape


# --------------------------------------------------------- loss and grads --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = jax_lm.init_model(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_jax(jax.device_get(jp), "cpu")
    toks = _tokens(jcfg, 1)
    (jl, jm), jg = jax.value_and_grad(jax_lm.loss_fn, has_aux=True)(
        jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tm, tg = lm.value_and_grad(tp, tcfg,
                                   {"tokens": torch.from_numpy(toks)})
    if dtype == "float32":
        tol = 2e-5
        assert abs(float(tl) - float(jl)) <= tol
        assert abs(float(tm["moe_aux"]) - float(jm["moe_aux"])) <= tol
        _close_trees(tg, jg, tol, f"{arch} grads")
        return
    assert abs(float(tl) - float(jl)) <= 3e-2 * abs(float(jl))
    for g, w in zip(tree.leaves(tg), jax.tree_util.tree_leaves(jg)):
        assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                           else torch.float32)
        scale = float(np.abs(np32(w)).max())
        assert float(np.abs(np32(g) - np32(w)).max()) <= 3e-2 * scale


# ------------------------------------------------------------- train step --

def _jax_state(cfg, opt):
    return jax_lm.init_train_state(jax.random.PRNGKey(0), cfg, opt)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mb,remat", [(1, True), (1, False), (4, True),
                                      (4, False)])
def test_train_step_adafactor_matches_jax(arch, mb, remat):
    """3 adafactor steps from one state: loss and params at 2e-5, the
    factored moments leaf for leaf at 1e-6, the step counter equal."""
    jcfg, tcfg = _cfgs(arch)
    js = _jax_state(jcfg, jopt.adafactor(1e-2))
    ts = train_state_from_jax(jax.device_get(js), "cpu")
    jstep = jax.jit(jax_lm.make_train_step(jcfg, jopt.adafactor(1e-2), mb,
                                           remat))
    tstep = lm.make_train_step(tcfg, topt.adafactor(1e-2), mb, remat)
    for s in range(3):
        toks = _tokens(jcfg, 10 + s)
        js, jm = jstep(js, {"tokens": jnp.asarray(toks)})
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(toks)})
        for key in ("loss", "ce", "moe_aux", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= 2e-5 * max(
                1.0, abs(float(jm[key]))), key
    _close_trees(ts.params, js.params, 2e-5, "params")
    _close_trees(ts.opt_state, js.opt_state, 1e-6, "adafactor state")
    assert int(ts.step) == int(js.step) == 3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mb,remat", [(1, True), (4, False)])
def test_train_step_adamw_matches_jax(arch, mb, remat):
    """One AdamW step: loss and grad norm at 2e-5, m and v leaf for leaf at
    1e-6, params at 2e-5 wherever the step's gradient g is 0 or |g| >=
    1e-6 (over 99% of the elements).  Adam's first step moves a parameter
    by lr * g / (|g| + eps): where |g| is ~eps (1e-8), a gradient that two
    summation orders give 1e-9 apart moves it by a share of lr, so there
    the params are held to the step's own bound, lr * (1 + wd * |p|).
    g is read from the JAX step's first moment, m = (1 - b1) g."""
    jcfg, tcfg = _cfgs(arch)
    lr = 1e-3
    js = _jax_state(jcfg, jopt.adamw(lr))
    ts = train_state_from_jax(jax.device_get(js), "cpu")
    toks = _tokens(jcfg, 20)
    js2, jm = jax.jit(jax_lm.make_train_step(jcfg, jopt.adamw(lr), mb,
                                             remat))(
        js, {"tokens": jnp.asarray(toks)})
    p0 = to_numpy(ts.params)
    ts2, tm = lm.make_train_step(tcfg, topt.adamw(lr), mb, remat)(
        ts, {"tokens": torch.from_numpy(toks)})
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= 2e-5 * max(
            1.0, abs(float(jm[key])))
    _close_trees(ts2.opt_state, js2.opt_state, 1e-6, "adamw state")
    n_cond = n_all = 0
    for m, p, got, want in zip(jax.tree_util.tree_leaves(js2.opt_state["m"]),
                               tree.leaves(p0),
                               tree.leaves(to_numpy(ts2.params)),
                               jax.tree_util.tree_leaves(js2.params)):
        err = np.abs(got - np.asarray(want))
        g = np.asarray(m) / np.float32(0.1)
        conditioned = (np.abs(g) >= 1e-6) | (g == 0)
        assert float(err[conditioned].max(initial=0.0)) <= 2e-5
        assert np.all(err <= lr * (1 + 0.1 * np.abs(p)) + 2e-5)
        n_cond += int(conditioned.sum())
        n_all += conditioned.size
    assert n_cond > 0.99 * n_all


def test_train_state_round_trip_and_policy():
    """A state crosses to the port and back leaf for leaf; the run policy
    is the JAX package's."""
    jcfg, tcfg = _cfgs("qwen3_moe_30b_a3b")
    js = _jax_state(jcfg, jopt.adamw(1e-3))
    params, opt_state, step = train_state_to_numpy(
        train_state_from_jax(jax.device_get(js), "cpu"))
    _close_trees(train_state_from_jax((params, opt_state, step), "cpu").params,
                 js.params, 0.0, "round trip")
    assert int(step) == 0 and set(opt_state) == {"step", "m", "v"}
    from repro.launch import specs as jspecs
    assert specs.RUN_POLICY == {
        k: specs.ArchRunPolicy(v.optimizer, v.num_microbatches, v.rules)
        for k, v in jspecs.RUN_POLICY.items()}
    assert specs.policy_for(tcfg).num_microbatches == 8
    w = {"w": torch.zeros(2, 3)}
    assert set(train.optimizer_for(get_config("nemotron_4_340b",
                                              reduced=True), 1e-3).init(w)
               ["v"]["w"]) == {"vr", "vc"}
    assert set(train.optimizer_for(tcfg, 1e-3).init(w)) == {"step", "m",
                                                            "v"}


def test_train_cli_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: the JAX driver's
    log lines, a finite loss, and a checkpoint that loads back."""
    state, metrics = train.main(["--steps", "2", "--batch", "2", "--seq",
                                 "16", "--device", "cpu",
                                 "--checkpoint-every", "2",
                                 "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=granite-3-8b reduced=True device=cpu" in out
    assert "step     1  loss=" in out and "step     2  loss=" in out
    assert out.strip().endswith("done.")
    assert np.isfinite(float(metrics["loss"])) and int(state.step) == 2
    back, meta = load_checkpoint(tmp_path / "granite-3-8b_2.npz",
                                 state.params)
    assert meta["step"] == 2
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(back),
                                                 tree.leaves(state.params)))
    assert launch_counts()["flash_attention"] == 0
