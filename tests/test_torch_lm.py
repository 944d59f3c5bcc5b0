"""The port's LM serving path, held against the JAX package on the CPU.

* The flash-attention wrapper on CPU tensors (its plain version) against
  the Pallas kernel run as tests/test_kernels.py runs it (interpret mode,
  bq=32, bk=16) and against ``gqa_attention_ref``: 3e-5 in fp32, 2e-2 in
  bf16 (the tolerances of tests/test_kernels.py).
* Layers (norms, interleaved/partial rotary, gated MLPs, the bf16
  embedding scale, unembed) against their JAX twins: fp32 1e-6 (the same
  arithmetic, one op), bf16 one bf16 ulp of the result.
* ``self_attention`` below the flash threshold, and with FLASH_MIN_SEQ
  monkeypatched small in both packages (JAX then takes its chunked
  fallback, the port the kernel's plain version); the ring-buffer decode
  step past its wrap.
* ``lm.forward``, ``prefill`` and ``serve_step`` for the reduced dense
  configs and a 4-layer gemma3 (n_super = 2), from the JAX parameters
  carried over by ``lm_params_from_jax``.  Logit error over the largest
  logit: 2e-5 in fp32 (matmuls summed in another order); 3e-2 in bf16
  (the two frameworks round bf16 intermediates at different places —
  XLA fuses elementwise chains in fp32 — and the difference grows
  through the layers; measured ~1.3e-2 at most).

Inputs are seeded numpy arrays handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jax_flash
from repro.kernels.flash_attention.ref import gqa_attention_ref as jax_flash_ref
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.models import mlp as jax_mlp
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, to_torch
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (
    band_mask, gqa_attention_ref, gqa_attention_ref_chunked, valid_pairs,
    worst_row_error)
from repro_torch.launch import serve
from repro_torch.models import attention, blocks, layers, lm, mlp
from repro_torch.models.config import BlockSpec

from torch_parity import DTYPES, as_jax, as_torch, np32

FLASH_SHAPES = [(2, 64, 4, 2, 32), (1, 100, 8, 8, 16), (2, 96, 4, 1, 32),
                (1, 130, 4, 2, 48)]
FLASH_MODES = [(True, 0), (True, 24), (False, 0)]
LM_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _ids(d):
    return d[0]


def _qkv(shape, seed):
    b, s, h, hkv, hd = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, s, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, s, hkv, hd)).astype(np.float32))


# ----------------------------------------------------------- the kernel ----

@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", FLASH_MODES)
@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_flash_matches_pallas_and_ref(shape, causal, window, dt):
    _, jdt, tdt = dt
    q, k, v = _qkv(shape, sum(shape))
    before = launch_counts()["flash_attention"]
    got = flash_ops.flash_attention(as_torch(q, tdt), as_torch(k, tdt),
                                    as_torch(v, tdt), causal=causal,
                                    window=window)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    assert launch_counts()["flash_attention"] == before   # CPU: no launch
    jq, jk, jv = as_jax(q, jdt), as_jax(k, jdt), as_jax(v, jdt)
    kernel = jax_flash(jq, jk, jv, causal=causal, window=window, bq=32,
                       bk=16, interpret=True)
    ref = jax_flash_ref(jq, jk, jv, causal=causal, window=window)
    tol = 3e-5 if dt[0] == "float32" else 2e-2
    for want in (kernel, ref):
        np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


def test_flash_reads_strided_inputs():
    """q/k/v views with strides over (B, S, H) give the contiguous result."""
    q, k, v = _qkv((2, 40, 4, 2, 16), 3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = flash_ops.flash_attention(tq, tk, tv, causal=True, window=8)
    sq = tq.transpose(1, 2).contiguous().transpose(1, 2)   # (B, H, S) order
    assert not sq.is_contiguous()
    got = flash_ops.flash_attention(sq, tk, tv, causal=True, window=8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["hd", "heads", "dtype", "stride", "window"])
def test_flash_wrapper_rejects(bad):
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 8, 4, 2, 32), 0))
    if bad == "hd":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    elif bad == "heads":
        q = torch.cat([q, q[:, :, :1]], dim=2)
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    kw = {"window": -1} if bad == "window" else {}
    with pytest.raises((ValueError, TypeError)):
        flash_ops.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("hd", [64, 128, 192, 256])
def test_flash_route_bf16_head_dims_take_the_tensor_cores(hd):
    strides = [hd, 4 * hd, 4 * 300 * hd]          # contiguous (B, S, H) of q
    assert flash_ops.route(torch.bfloat16, hd, strides, 16) == "sm90"


@pytest.mark.parametrize("dtype,hd",
                         [(torch.float32, hd) for hd in flash_ops.HEAD_DIMS]
                         + [(torch.bfloat16, hd) for hd in (16, 32, 48, 96)])
def test_flash_route_fp32_and_small_bf16_take_the_cuda_cores(dtype, hd):
    """The fma route reads through plain pointers: odd strides and
    alignments are fine there."""
    assert flash_ops.route(dtype, hd, [hd, 3, 7], 2) == "fma"


@pytest.mark.parametrize("strides,align", [([128, 12], 16), ([128, 0], 16),
                                           ([-8, 128], 16), ([128, 64], 8)])
def test_flash_route_sm90_raises_on_what_the_tma_cannot_read(strides, align):
    with pytest.raises(ValueError, match="TMA"):
        flash_ops.route(torch.bfloat16, 128, strides, align)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_cpu_tensors_take_the_plain_version(hd):
    """bf16 CPU tensors at a tensor-core head dim, even through views the
    TMA could not read, run the plain version and launch nothing."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv((1, 40, 4, 2, hd + 2), hd))
    q, k, v = q[..., 1:hd + 1], k[..., :hd], v[..., :hd]   # H stride hd + 2
    before = launch_counts()["flash_attention"], flash_ops.route_counts()
    got = flash_ops.flash_attention(q, k, v, causal=True, window=16)
    want = gqa_attention_ref(q, k, v, causal=True, window=16)
    assert torch.equal(got, want)
    assert (launch_counts()["flash_attention"],
            flash_ops.route_counts()) == before


def test_worst_row_error_catches_one_tile_of_keys():
    """The per-row bound (max|want| / 64) passes bf16 rounding of the plain
    version and fails a band one 128-key tile too wide."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 640, 4, 2, 64), 7))
    want = gqa_attention_ref(q, k, v, causal=True, window=256)
    rounded = want.to(torch.bfloat16)
    assert worst_row_error(rounded, want) <= 1 / 256
    wide = gqa_attention_ref(q, k, v, causal=True, window=256 + 128)
    assert worst_row_error(wide, want) > 1 / 64
    zero = torch.zeros_like(want)
    assert worst_row_error(zero + 1e-3, zero) == pytest.approx(1e-3)


@pytest.mark.parametrize("sq,skv,causal,window",
                         [(37, 37, True, 0), (37, 37, True, 5),
                          (37, 20, True, 0), (20, 37, False, 6),
                          (64, 64, False, 0), (9, 9, True, 100),
                          (50, 10, True, 4), (12, 30, False, 5)])
def test_valid_pairs_counts_the_mask(sq, skv, causal, window):
    want = int(band_mask(sq, skv, causal, window, "cpu").sum())
    assert valid_pairs(sq, skv, causal, window) == want


@pytest.mark.parametrize("shape", [(1, 130, 4, 2, 48), (2, 96, 4, 1, 32)])
@pytest.mark.parametrize("causal,window", FLASH_MODES)
@pytest.mark.parametrize("rows", [16, 37])
def test_chunked_plain_version_matches_jax_ref(shape, causal, window, rows):
    """The plain version over query-row chunks (a chunk's rows placed by
    ``q_offset``, causal chunks cut to their keys) gives the whole, fp32
    3e-5 against the JAX reference."""
    q, k, v = _qkv(shape, sum(shape) + rows)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = gqa_attention_ref_chunked(tq, tk, tv, causal=causal, window=window,
                                    rows=rows)
    want = jax_flash_ref(as_jax(q, jnp.float32), as_jax(k, jnp.float32),
                         as_jax(v, jnp.float32), causal=causal, window=window)
    np.testing.assert_allclose(np32(got), np32(want), rtol=3e-5, atol=3e-5)


# --------------------------------------------------------------- layers ----

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_apply_norm(norm, dt):
    _, jdt, tdt = dt
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    p = {"scale": rng.normal(size=(48,)).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.normal(size=(48,)).astype(np.float32)
    got = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            as_torch(x, tdt), norm)
    want = jax_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                 as_jax(x, jdt), norm)
    assert got.dtype == tdt
    tol = 1e-6 if dt[0] == "float32" else 8e-3
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("pct", [1.0, 0.5])
@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_apply_rotary_interleaved(pct, dt):
    _, jdt, tdt = dt
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 3, 32)).astype(np.float32)
    pos = np.arange(100, 109, dtype=np.int32)[None]
    rot = int(32 * pct)
    cos, sin = layers.rotary_angles(torch.from_numpy(pos), rot, 10_000.0)
    jcos, jsin = jax_layers.rotary_angles(jnp.asarray(pos), rot, 10_000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=2e-6)
    got = layers.apply_rotary(as_torch(x, tdt), cos, sin, pct)
    want = jax_layers.apply_rotary(as_jax(x, jdt), jcos, jsin, pct)
    tol = 1e-5 if dt[0] == "float32" else 1.6e-2
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)
    if pct < 1:   # the pass-through half is untouched
        np.testing.assert_array_equal(np32(got)[..., rot:],
                                      np32(as_torch(x, tdt))[..., rot:])


@pytest.mark.parametrize("act", ["geglu", "swiglu", "squared_relu"])
@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_apply_mlp(act, dt):
    _, jdt, tdt = dt
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    p = {"w_up": rng.normal(size=(32, 64)) / 6,
         "w_down": rng.normal(size=(64, 32)) / 8}
    if act in mlp.GATED:
        p["w_gate"] = rng.normal(size=(32, 64)) / 6
    got = mlp.apply_mlp({k: as_torch(v, tdt) for k, v in p.items()},
                        as_torch(x, tdt), act)
    want = jax_mlp.apply_mlp({k: as_jax(v, jdt) for k, v in p.items()},
                             as_jax(x, jdt), act)
    tol = 2e-6 if dt[0] == "float32" else 3e-2
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


def test_embed_scale_is_applied_in_bf16():
    """sqrt(5376) = 73.32 rounds to 73.5 in bf16 before the multiply."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 5376)).astype(np.float32) / 70
    toks = rng.integers(0, 50, (2, 7)).astype(np.int32)
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        got = layers.embed_tokens({"table": as_torch(table, tdt)},
                                  torch.from_numpy(toks), scale=True)
        want = jax_layers.embed_tokens({"table": as_jax(table, jdt)},
                                       jnp.asarray(toks), scale=True)
        np.testing.assert_array_equal(np32(got), np32(want))
    row = as_torch(table, torch.bfloat16)[toks[0, 0]]
    np.testing.assert_array_equal(
        np32(layers.embed_tokens({"table": as_torch(table, torch.bfloat16)},
                                 torch.from_numpy(toks), scale=True)[0, 0]),
        np32(row * torch.tensor(73.5, dtype=torch.bfloat16)))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_unembed(softcap):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    table = rng.normal(size=(97, 64)).astype(np.float32)
    got = layers.unembed({"table": as_torch(table, torch.bfloat16)},
                         as_torch(x, torch.bfloat16), softcap=softcap)
    want = jax_layers.unembed({"table": as_jax(table, jnp.bfloat16)},
                              as_jax(x, jnp.bfloat16), softcap=softcap)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


# ------------------------------------------------------------ attention ----

def _attn_case(arch="gemma3_27b", dtype="float32", **over):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               param_dtype=dtype, compute_dtype=dtype, **over)
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               param_dtype=dtype, compute_dtype=dtype, **over)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jax_attn.init_attention(jax.random.PRNGKey(7), jcfg, jdt)
    tp = to_torch(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("mode", ["full", "local"])
@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_self_attention(mode, flash, dt, monkeypatch):
    name, jdt, tdt = dt
    jcfg, tcfg, jp, tp = _attn_case(dtype=name)
    if flash:   # both packages take their long-sequence branch
        monkeypatch.setattr(jax_attn, "FLASH_MIN_SEQ", 16)
        monkeypatch.setattr(jax_attn, "FLASH_CHUNK", 8)
        monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 16)
    x = np.random.default_rng(8).normal(size=(2, 37, 256)).astype(np.float32)
    got = attention.self_attention(tp, tcfg, as_torch(x, tdt), mode=mode,
                                   window=5)
    want = jax_attn.self_attention(jp, jcfg, as_jax(x, jdt), mode=mode,
                                   window=5)
    tol = 1e-5 if name == "float32" else 2e-2
    scale = float(np.abs(np32(want)).max())
    assert np.abs(np32(got) - np32(want)).max() <= tol * scale


@pytest.mark.parametrize("dt", DTYPES, ids=_ids)
def test_decode_ring_buffer_past_the_wrap(dt):
    """A local layer with a 4-slot ring over 11 steps, a global layer with
    an 11-slot cache: outputs and caches follow the JAX package."""
    name, jdt, tdt = dt
    jcfg, tcfg, jp, tp = _attn_case(dtype=name)
    b, hkv, hd = 2, tcfg.num_kv_heads, tcfg.head_dim_
    xs = np.random.default_rng(9).normal(size=(11, b, 1, 256)).astype(
        np.float32)
    tol = 1e-5 if name == "float32" else 2e-2
    for mode, c in (("local", 4), ("full", 11)):
        jc = jax_attn.KVCache.zeros(b, c, hkv, hd, jdt)
        tc = attention.KVCache.zeros(b, c, hkv, hd, tdt, "cpu")
        for pos in range(11):
            want, jc = jax_attn.decode_self_attention(
                jp, jcfg, as_jax(xs[pos], jdt), jc, jnp.int32(pos), mode=mode)
            got, tc = attention.decode_self_attention(
                tp, tcfg, as_torch(xs[pos], tdt), tc, pos, mode=mode)
            scale = float(np.abs(np32(want)).max())
            assert np.abs(np32(got) - np32(want)).max() <= tol * scale
            np.testing.assert_allclose(np32(tc.k), np32(jc.k), rtol=tol,
                                       atol=tol)
            np.testing.assert_allclose(np32(tc.v), np32(jc.v), rtol=tol,
                                       atol=tol)


def test_unported_blocks_raise():
    """Every mixer is ported now (the name is kept from when mamba, the
    xLSTM mixers and cross-attention raised): mamba, mLSTM, sLSTM and
    cross-attention blocks, and the MoE feed-forward, build with the JAX
    package's leaf shapes and dtypes (a bf16 model, fp32 where the JAX
    init makes fp32); an unknown mixer raises ``ValueError`` as there."""
    from repro.models import blocks as jax_blocks
    from repro.models.config import BlockSpec as JaxBlockSpec
    gen = torch.Generator().manual_seed(0)
    cases = [("jamba_1p5_large_398b", ("mamba", "dense", False)),
             ("xlstm_1p3b", ("mlstm", "none", False)),
             ("xlstm_1p3b", ("slstm", "none", False)),
             ("whisper_medium", ("attn", "dense", True)),
             ("qwen3_moe_30b_a3b", ("attn", "moe", False))]
    for arch, (mixer, ff, cross) in cases:
        jcfg, tcfg = _lm_cfgs(arch, "bfloat16")
        want = jax.eval_shape(lambda: jax_blocks.init_block(
            jax.random.PRNGKey(0), jcfg, JaxBlockSpec(mixer, ff, cross),
            jnp.bfloat16))
        got = blocks.init_block(gen, tcfg, BlockSpec(mixer, ff, cross),
                                torch.bfloat16)
        wl, wt = jax.tree_util.tree_flatten(want)
        assert jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda _: 0, got)) == wt, (arch, mixer)
        for g, w in zip(tree.leaves(got), wl):
            assert tuple(g.shape) == tuple(w.shape), (arch, mixer)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (arch, mixer)
        assert ("cross" in got) == cross
    with pytest.raises(ValueError, match="conv"):
        blocks.init_block(gen, tcfg, BlockSpec("conv", "dense"),
                          torch.float32)


# ------------------------------------------------------------------- lm ----

def _lm_cfgs(arch, dtype, layers_=None):
    over = dict(param_dtype=dtype, compute_dtype=dtype)
    if layers_:
        over["num_layers"] = layers_
    return (dataclasses.replace(jax_get_config(arch, reduced=True), **over),
            dataclasses.replace(get_config(arch, reduced=True), **over))


LM_CASES = [("gemma3_27b", None), ("granite_3_8b", None),
            ("chatglm3_6b", None), ("nemotron_4_340b", None),
            ("gemma3_27b", 4)]


def _rel_err(got, want) -> float:
    got, want = np32(got), np32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch,n_layers", LM_CASES,
                         ids=[f"{a}-{n or 'reduced'}" for a, n in LM_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_prefill_and_serve_match_jax(arch, n_layers, dtype):
    jcfg, tcfg = _lm_cfgs(arch, dtype, n_layers)
    if n_layers == 4:
        assert lm.plan_for(tcfg).n_super == 2
    jp = jax_lm.init_model(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_jax(jax.device_get(jp), "cpu")
    b, s = 2, 20                       # s > the reduced window (16)
    toks = np.random.default_rng(10).integers(
        0, jcfg.vocab_size, (b, s)).astype(np.int32)
    tol = LM_TOL[dtype]

    want, _ = jax_lm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                             remat=False)
    got, aux = lm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert _rel_err(got, want) <= tol

    last = lm.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tuple(last.shape) == (b, tcfg.vocab_size)
    assert _rel_err(last, want[:, -1]) <= tol

    jserve = jax.jit(jax_lm.make_serve_step(jcfg))
    tserve = lm.make_serve_step(tcfg)
    jstate = jax_lm.init_decode_state(jp, jcfg, b, s)
    tstate = lm.init_decode_state(tp, tcfg, b, s)
    for t in range(s):
        jl, jstate = jserve(jp, jstate, jnp.asarray(toks[:, t:t + 1]))
        tl, tstate = tserve(tp, tstate, torch.from_numpy(toks[:, t:t + 1]))
        assert _rel_err(tl, jl) <= tol
    assert tstate.pos == s == int(jstate.pos)


@pytest.mark.parametrize("arch,n_layers", LM_CASES,
                         ids=[f"{a}-{n or 'reduced'}" for a, n in LM_CASES])
def test_decode_matches_forward(arch, n_layers):
    """The port's own contract, as tests/test_decode_consistency.py holds
    the JAX package's: decode over the prompt reproduces the forward
    logits at every position (fp32, 5e-5 of the largest logit)."""
    _, tcfg = _lm_cfgs(arch, "float32", n_layers)
    tp = lm.init_model(tcfg, torch.Generator().manual_seed(1), "cpu")
    b, s = 2, 20
    toks = torch.randint(0, tcfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(2))
    full, _ = lm.forward(tp, tcfg, {"tokens": toks})
    step = lm.make_serve_step(tcfg)
    state = lm.init_decode_state(tp, tcfg, b, s)
    outs = []
    for t in range(s):
        lg, state = step(tp, state, toks[:, t:t + 1])
        outs.append(lg)
    assert _rel_err(torch.stack(outs, 1), full) < 5e-5


def test_flash_branch_inside_the_model(monkeypatch):
    """With the threshold monkeypatched below the prompt, every attention
    layer goes through the flash wrapper (its plain version here) and the
    logits still follow the JAX package's chunked branch."""
    jcfg, tcfg = _lm_cfgs("gemma3_27b", "float32", 4)
    monkeypatch.setattr(jax_attn, "FLASH_MIN_SEQ", 16)
    monkeypatch.setattr(jax_attn, "FLASH_CHUNK", 8)
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 16)
    calls = []
    real = flash_ops.flash_attention
    monkeypatch.setattr(flash_ops, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    jp = jax_lm.init_model(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_jax(jax.device_get(jp), "cpu")
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (1, 40)).astype(np.int32)
    want, _ = jax_lm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                             remat=False)
    got = lm.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert _rel_err(got, want[:, -1]) <= LM_TOL["float32"]
    assert [c["window"] for c in calls] == [16, 0, 16, 0]


def test_init_model_matches_the_jax_tree():
    """Same tree, shapes and dtypes as the JAX init; scales as its init
    (1/sqrt(fan_in), wo at 1/sqrt(h*hd), norms at one)."""
    for arch in ("gemma3_27b", "chatglm3_6b", "nemotron_4_340b"):
        jcfg, tcfg = _lm_cfgs(arch, "bfloat16", 4)
        want = jax.eval_shape(
            lambda: jax_lm.init_model(jax.random.PRNGKey(0), jcfg))
        got = lm.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
        wl, wt = jax.tree_util.tree_flatten(want)

        gl = tree.leaves(got)
        assert len(gl) == len(wl)
        assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda _: 0, got)) == wt)
        for g, w in zip(gl, wl):
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
    wo = got["stack"]["super"]["p0"]["mixer"]["wo"].float()
    h, hd = tcfg.num_heads, tcfg.head_dim_
    assert abs(float(wo.std()) * (h * hd) ** 0.5 - 1.0) < 0.05
    assert torch.all(got["final_norm"]["scale"] == 1)
    tbl = got["embed"]["table"].float()
    assert abs(float(tbl.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05


def test_lm_params_from_jax_is_bit_exact():
    jcfg, _ = _lm_cfgs("gemma3_27b", "bfloat16")
    jp = jax.device_get(jax_lm.init_model(jax.random.PRNGKey(3), jcfg))
    tp = lm_params_from_jax(jp, "cpu")

    for g, w in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(np32(g), np.asarray(w, np.float32))
    with pytest.raises(ValueError):
        lm_params_from_jax({"embed": {}}, "cpu")


def test_serve_main_on_cpu(capsys):
    seq = serve.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                      "--sample", "greedy"])
    assert tuple(seq.shape) == (2, 4)
    assert "ms/token" in capsys.readouterr().out


def test_samplers():
    logits = torch.from_numpy(np.random.default_rng(12).normal(
        size=(3, 100)).astype(np.float32))
    greedy = serve.sample_greedy(logits)
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.argmax(logits.numpy(), -1))
    gen = torch.Generator().manual_seed(0)
    top = serve.sample_topk(logits, gen, k=5)
    allowed = torch.topk(logits, 5, dim=-1).indices
    assert top.dtype == torch.int32
    assert all(int(t) in allowed[i].tolist() for i, t in enumerate(top))
