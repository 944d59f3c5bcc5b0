"""The port's MoE family, held against the JAX package on the CPU.

* Routing (``route``): expert ids equal, probabilities and the
  load-balance loss at 1e-6 (fp32), ties to the lower expert id as
  ``lax.top_k`` breaks them.
* ``_positions_in_expert`` and ``_capacity`` equal, with and without a
  capacity overflow.
* ``apply_moe`` (the JAX package's ``_apply_moe_gspmd``, one block) and
  its gradients: fp32 at 2e-5; bf16 within 3e-2 of the largest |output|
  (the frameworks round bf16 intermediates at different places); with
  experts overflowing their capacity and without.
* ``lm.forward`` for the reduced qwen3-moe-30b-a3b and
  granite-moe-1b-a400m: logits and aux, fp32 at 2e-5 and bf16 at 5e-2 of
  the largest |logit| (the dense family's 3e-2 plus routing: in bf16 a
  near-tie of two router probabilities can send a token to another
  expert; measured 4.0e-2 at one token of granite-moe, 1.0e-2 elsewhere).
* Decode equals forward where no expert drops a token (capacity for
  every token, asserted: the forward's capacity is T = B * S, decode's B).
* Two runs give the same bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro.models.config import MoEConfig as JaxMoEConfig
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, to_torch
from repro_torch.models import lm, moe
from repro_torch.models.config import MoEConfig

from torch_parity import DTYPES, as_jax, as_torch, np32

MOE_ARCHS = ["qwen3_moe_30b_a3b", "granite_moe_1b_a400m"]
LM_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
FORWARD_TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _moe_params(d, e, f, seed, gated=True):
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, e)) / np.sqrt(d),
         "w_up": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    if gated:
        p["w_gate"] = rng.normal(size=(e, d, f)) / np.sqrt(d)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _cast(p, jdt, tdt):
    jp = {k: as_jax(v, jnp.float32 if k == "router" else jdt)
          for k, v in p.items()}
    tp = {k: as_torch(v, torch.float32 if k == "router" else tdt)
          for k, v in p.items()}
    return jp, tp


def test_capacity_and_positions_match_jax():
    """Capacity padding, and each assignment's rank in its expert (stable,
    in token order) with overflow past the capacity."""
    for t, k, e, cf in [(8, 2, 4, 1.25), (256, 8, 128, 1.25), (3, 1, 2, 0.5),
                        (4096, 8, 128, 1.25)]:
        assert moe._capacity(t, MoEConfig(e, k, 8, cf)) == \
            jax_moe._capacity(t, JaxMoEConfig(e, k, 8, cf))
    rng = np.random.default_rng(0)
    for n, e, cap in [(64, 4, 8), (64, 4, 40), (200, 7, 16)]:
        ids = rng.integers(0, e, n).astype(np.int32)
        ids[:20] = 1                               # one expert overflows
        wp, wk = jax_moe._positions_in_expert(jnp.asarray(ids), e, cap)
        gp, gk = moe._positions_in_expert(torch.from_numpy(ids).long(), e,
                                          cap)
        assert np.array_equal(gp.numpy(), np.asarray(wp))
        assert np.array_equal(gk.numpy(), np.asarray(wk))
        assert (not gk.all()) == (np.bincount(ids, minlength=e).max() > cap)


def test_route_matches_jax_with_ties():
    """Ids equal (a tie keeps the lower expert id), probabilities and the
    aux loss at 1e-6."""
    d, e = 16, 8
    p = _moe_params(d, e, 4, 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(40, d)).astype(np.float32)
    x[:5] = 0.0                       # all-zero logits: every expert ties
    for k in (1, 2, 4):
        cfgj, cfgt = JaxMoEConfig(e, k, 4), MoEConfig(e, k, 4)
        wi, wp, wa = jax_moe.route(jax.tree_util.tree_map(jnp.asarray, p),
                                   jnp.asarray(x), cfgj)
        gi, gp, ga = moe.route(to_torch(p, "cpu"), torch.from_numpy(x), cfgt)
        assert np.array_equal(gi.numpy(), np.asarray(wi))
        assert np.array_equal(gi[:5].numpy(),
                              np.tile(np.arange(k), (5, 1)))
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-6,
                                   atol=1e-6)
        assert abs(float(ga) - float(wa)) <= 1e-6


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["fits", "overflow"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
def test_apply_moe_and_grads_match_jax(cf, act, dt):
    """Output, aux loss and the gradients of sum(out * ct) for x and every
    weight; capacity factor 0.5 drops assignments (asserted)."""
    name, jdt, tdt = dt
    b, s, d, e, k, f = 2, 12, 16, 6, 2, 8
    p = _moe_params(d, e, f, 3, gated=act == "swiglu")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    ct = rng.normal(size=(b, s, d)).astype(np.float32)
    cfgj, cfgt = JaxMoEConfig(e, k, f, cf), MoEConfig(e, k, f, cf)
    jp, tp = _cast(p, jdt, tdt)

    def jfn(params, xx):
        y, a = jax_moe._apply_moe_gspmd(params, xx, cfgj, act)
        return jnp.sum(y.astype(jnp.float32) * ct) + a, (y, a)

    (_, (wy, wa)), (wgp, wgx) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jp, as_jax(x, jdt))
    tx = as_torch(x, tdt).requires_grad_(True)
    tpr = {k_: v.requires_grad_(True) for k_, v in tp.items()}
    gy, ga = moe.apply_moe(tpr, tx, cfgt, act)
    ((gy.float() * torch.from_numpy(ct)).sum() + ga).backward()
    ids, _, _ = moe.route(tp, torch.from_numpy(x).to(tdt).reshape(-1, d),
                          cfgt)
    cap = moe._capacity(b * s, cfgt)
    _, keep = moe._positions_in_expert(ids.reshape(-1), e, cap)
    assert bool(keep.all()) == (cf == 1.25)
    tol = LM_TOL[name]
    scale = float(np.abs(np32(wy)).max())
    assert float(np.abs(np32(gy) - np32(wy)).max()) <= tol * scale
    assert abs(float(ga.detach()) - float(wa)) <= 1e-6
    for got, want in [(tx.grad, wgx)] + [(tpr[k_].grad, wgp[k_])
                                         for k_ in p]:
        sc = max(float(np.abs(np32(want)).max()), 1e-6)
        assert float(np.abs(np32(got) - np32(want)).max()) <= tol * sc


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_matches_jax(arch, dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
    jp = jax_lm.init_model(jax.random.PRNGKey(1), jcfg)
    tp = lm_params_from_jax(jax.device_get(jp), "cpu")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 24))
    want, waux = jax_lm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                remat=False)
    got, gaux = lm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    scale = float(np.abs(np.asarray(want)).max())
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= \
        FORWARD_TOL[dtype] * scale
    assert abs(float(gaux) - float(waux)) <= LM_TOL[dtype] * float(waux)
    assert float(gaux) > 0.0


def _no_drops(monkeypatch):
    """Record every dispatch's keep mask."""
    seen = []
    real = moe._positions_in_expert

    def spy(flat_ids, e, cap):
        pos, keep = real(flat_ids, e, cap)
        seen.append(bool(keep.all()))
        return pos, keep

    monkeypatch.setattr(moe, "_positions_in_expert", spy)
    return seen


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_equals_forward_without_drops(arch, monkeypatch):
    """fp32: decode from an empty cache reproduces the forward's logits at
    every position, where no dispatch (forward at T = B * S, decode at B)
    drops an assignment.  At the configs' capacity factor of 1.25 random
    weights overflow an expert at most seeds (and then the forward drops
    what decode keeps), so the experts get room for every token (factor
    E / k) and the test asserts that nothing was dropped."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              param_dtype="float32", compute_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params = lm.init_model(cfg, torch.Generator().manual_seed(2), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(3))
    seen = _no_drops(monkeypatch)
    full, _ = lm.forward(params, cfg, {"tokens": toks})
    state = lm.init_decode_state(params, cfg, 2, 16)
    step = lm.make_serve_step(cfg)
    outs = []
    for t in range(16):
        lg, state = step(params, state, toks[:, t:t + 1])
        outs.append(lg)
    assert seen and all(seen), "an expert overflowed: the check needs none"
    assert len(seen) == cfg.num_layers * 17
    dec = torch.stack(outs, 1)
    assert float((dec - full).abs().max()) <= 1e-4 * float(full.abs().max())


def test_moe_runs_are_bit_equal_and_configs_load():
    cfg = get_config("qwen3_moe_30b_a3b", reduced=True)
    params = lm.init_model(cfg, torch.Generator().manual_seed(4), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(5))
    a, _ = lm.forward(params, cfg, {"tokens": toks})
    b, _ = lm.forward(params, cfg, {"tokens": toks})
    assert torch.equal(a, b)
    for arch in MOE_ARCHS:
        full = get_config(arch)
        assert dataclasses.asdict(full) == dataclasses.asdict(
            jax_get_config(arch))
        assert full.family == "moe" and full.moe.top_k == 8
    p = tree.leaves(params["stack"]["super"]["p0"]["ff"])
    assert {tuple(t.shape) for t in p} == {(2, 4, 256, 128), (2, 4, 128, 256),
                                          (2, 256, 4)}
