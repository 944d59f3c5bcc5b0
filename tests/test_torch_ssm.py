"""The port's Mamba block (``repro_torch.models.ssm``), on the CPU.

* ``_scan_chunk`` (the Hillis-Steele scan) against the step-by-step
  recurrence, with a carry, at chunk lengths that are and are not powers
  of two: fp32 at 1e-6 of the largest |h|.
* The chunked forward against the port's own step-by-step decode at
  chunks 1/4/16/256, the port's version of
  tests/test_xlstm_mamba_reference.py (rtol = atol = 3e-4, as there).
* ``mamba_forward`` and ``mamba_decode`` against the JAX package's on one
  set of parameters carried over: fp32 within 1e-5 of the largest
  |value|, bf16 within 2e-2 (the frameworks round bf16 intermediates at
  different places); the decode states too.
* ``layers.softplus`` (Mamba's ``dt``) is ``jax.nn.softplus``
  (``logaddexp(x, 0)``) within two float32 ulps (``exp``/``log1p`` of the
  two libraries), also above 20 where ``F.softplus`` returns ``x``.
* ``init_mamba``: the JAX init's tree, shapes and dtypes (fp32
  ``a_log``/``dt_bias``/``d_skip`` in a bf16 model), stacked by ``lead``.

Inputs are seeded numpy arrays handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jax_ssm
from repro.models.config import MambaConfig as JaxMambaConfig
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import to_torch
from repro_torch.models import layers, ssm
from repro_torch.models.config import MambaConfig

from torch_parity import DTYPES, as_jax, as_torch, np32


def _cfgs(d_model=32, d_state=4, dtype="float32"):
    kw = dict(d_model=d_model, param_dtype=dtype, compute_dtype=dtype)
    jc = dataclasses.replace(
        jax_get_config("jamba_1p5_large_398b", reduced=True),
        mamba=JaxMambaConfig(d_state=d_state, d_conv=4, expand=2), **kw)
    tc = dataclasses.replace(
        get_config("jamba_1p5_large_398b", reduced=True),
        mamba=MambaConfig(d_state=d_state, d_conv=4, expand=2), **kw)
    return jc, tc


def _params(jcfg, jdt, seed=0):
    """The JAX init's parameters, and the same on the port's side."""
    jp = jax_ssm.init_mamba(jax.random.PRNGKey(seed), jcfg, jdt)
    return jp, to_torch(jax.device_get(jp), "cpu")


def _rel(got, want) -> float:
    got, want = np32(got), np32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("q", [1, 2, 5, 8, 13, 64])
def test_scan_chunk_matches_the_recurrence(q):
    rng = np.random.default_rng(q)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, q, 3, 4))
                         .astype(np.float32))
    bx = torch.from_numpy(rng.normal(size=(2, q, 3, 4)).astype(np.float32))
    carry = torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32))
    last, hs = ssm._scan_chunk(carry, a, bx)
    h, want = carry.double(), []
    for t in range(q):
        h = a[:, t].double() * h + bx[:, t].double()
        want.append(h)
    want = torch.stack(want, 1)
    scale = float(want.abs().max())
    assert float((hs.double() - want).abs().max()) <= 1e-6 * scale
    assert torch.equal(last, hs[:, -1])


@pytest.mark.parametrize("chunk", [1, 4, 16, 256])
def test_chunked_forward_matches_step_decode(chunk):
    jcfg, tcfg = _cfgs()
    _, p = _params(jcfg, jnp.float32, seed=1)
    b, s = 2, 19
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(b, s, tcfg.d_model)).astype(np.float32))
    y = ssm.mamba_forward(p, tcfg, x, chunk=chunk)
    st = ssm.MambaState.zeros(b, tcfg, torch.float32, "cpu")
    outs = []
    for t in range(s):
        o, st = ssm.mamba_decode(p, tcfg, x[:, t:t + 1], st)
        outs.append(o)
    np.testing.assert_allclose(y.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
def test_forward_and_decode_match_jax(dt):
    name, jdt, tdt = dt
    jcfg, tcfg = _cfgs(d_model=48, d_state=8, dtype=name)
    jp, tp = _params(jcfg, jdt, seed=2)
    b, s = 2, 37
    x = np.random.default_rng(2).normal(size=(b, s, 48)).astype(np.float32)
    tol = 1e-5 if name == "float32" else 2e-2
    for chunk in (8, 256):
        want = jax_ssm.mamba_forward(jp, jcfg, as_jax(x, jdt), chunk=chunk)
        got = ssm.mamba_forward(tp, tcfg, as_torch(x, tdt), chunk=chunk)
        assert got.dtype == tdt and _rel(got, want) <= tol, chunk
    jst = jax_ssm.MambaState.zeros(b, jcfg, jdt)
    tst = ssm.MambaState.zeros(b, tcfg, tdt, "cpu")
    for t in range(5):
        want, jst = jax_ssm.mamba_decode(jp, jcfg, as_jax(x[:, t:t + 1], jdt),
                                         jst)
        got, tst = ssm.mamba_decode(tp, tcfg, as_torch(x[:, t:t + 1], tdt),
                                    tst)
        assert _rel(got, want) <= tol, t
    assert tst.conv.dtype == tdt and tst.ssm.dtype == torch.float32
    for g, w in zip(tst, jst):
        assert tuple(g.shape) == tuple(w.shape)
        assert _rel(g, w) <= tol


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-40, 40, 801), [0.0, 19.99, 20.01, 88.0]]
                       ).astype(np.float32)
    got = layers.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -23, atol=0)


def test_init_matches_the_jax_tree():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    want = jax.eval_shape(
        lambda: jax_ssm.init_mamba(jax.random.PRNGKey(0), jcfg,
                                   jnp.bfloat16))
    got = ssm.init_mamba(torch.Generator().manual_seed(0), tcfg,
                         torch.bfloat16, lead=(3,))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == (3,) + tuple(w.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    for k in ("a_log", "dt_bias", "d_skip"):
        assert got[k].dtype == torch.float32
    np.testing.assert_array_equal(
        got["a_log"][1].numpy(),
        np.asarray(jax_ssm.init_mamba(jax.random.PRNGKey(0), jcfg,
                                      jnp.bfloat16)["a_log"]))
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-6 and float(dt.max()) <= 1e-1 + 1e-6
    assert len(tree.leaves(got)) == len(want)
