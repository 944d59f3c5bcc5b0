"""The port's xLSTM blocks (``repro_torch.models.xlstm``), on the CPU.

* ``_mlstm_chunk`` run chunk by chunk against a float64 step-by-step
  stabilised recurrence at chunks 1/3/8/64 (rtol = atol = 2e-4, the
  tolerance of tests/test_xlstm_mamba_reference.py).
* sLSTM and mLSTM decode, step by step, against their forward.
* ``mlstm_forward``/``mlstm_decode`` and ``slstm_forward``/``slstm_decode``
  against the JAX package's on one set of parameters carried over: fp32
  within 1e-5 of the largest |value|, bf16 within 2e-2; the decode states
  too.
* ``init_mlstm``/``init_slstm``: the JAX init's tree, shapes and dtypes
  (fp32 gates, biases and recurrent weights in a bf16 model), the
  forget-gate bias 3.0 and the z/i/f/o order of ``b_gates``.

Inputs are seeded numpy arrays handed to both packages.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import xlstm as jax_xlstm
from repro_torch.configs import get_config
from repro_torch.convert import to_torch
from repro_torch.models import xlstm

from torch_parity import DTYPES, as_jax, as_torch, np32


def _cfgs(d_model=32, dtype="float32"):
    kw = dict(d_model=d_model, param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jax_get_config("xlstm_1p3b", reduced=True),
                                **kw),
            dataclasses.replace(get_config("xlstm_1p3b", reduced=True), **kw))


def _rel(got, want) -> float:
    got, want = np32(got), np32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _naive_mlstm(q, k, v, log_i, log_f):
    """The exact stabilised recurrence in float64, one step at a time.
    q, k, v (B, S, H, hd); gates (B, S, H)."""
    b, s, h, hd = q.shape
    c = np.zeros((b, h, hd, hd))
    n = np.zeros((b, h, hd))
    m = np.full((b, h), -1e30)
    outs = []
    for t in range(s):
        m_new = np.maximum(log_f[:, t] + m, log_i[:, t])
        fs = np.exp(log_f[:, t] + m - m_new)
        is_ = np.exp(log_i[:, t] - m_new)
        c = fs[..., None, None] * c + is_[..., None, None] * (
            k[:, t][..., :, None] * v[:, t][..., None, :])
        n = fs[..., None] * n + is_[..., None] * k[:, t]
        num = np.einsum("bhd,bhde->bhe", q[:, t], c)
        den = np.abs(np.einsum("bhd,bhd->bh", q[:, t], n))
        outs.append(num / np.maximum(den, np.exp(-m_new))[..., None])
        m = m_new
    return np.stack(outs, 1)


@pytest.mark.parametrize("chunk", [1, 3, 8, 64])
def test_mlstm_chunkwise_matches_naive(chunk):
    b, s, h, hd = 2, 24, 2, 8
    rng = np.random.default_rng(chunk)
    q = rng.normal(size=(b, s, h, hd)) / math.sqrt(hd)
    k, v = rng.normal(size=(2, b, s, h, hd))
    log_i = rng.normal(size=(b, s, h))
    log_f = -np.logaddexp(0.0, -(rng.normal(size=(b, s, h)) - 2.0))
    want = _naive_mlstm(q, k, v, log_i, log_f)

    t32 = [torch.from_numpy(a.astype(np.float32))
           for a in (q, k, v, log_i, log_f)]
    st = xlstm.MLSTMState(c=torch.zeros(b, h, hd, hd),
                          n=torch.zeros(b, h, hd),
                          m=torch.full((b, h), -1e30))
    outs = []
    for c0 in range(0, s, chunk):
        st, out = xlstm._mlstm_chunk(st, *(t[:, c0:c0 + chunk] for t in t32))
        outs.append(out)
    got = torch.cat(outs, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_forward(kind):
    jcfg, tcfg = _cfgs()
    init = getattr(jax_xlstm, f"init_{kind}")
    p = to_torch(jax.device_get(init(jax.random.PRNGKey(2), jcfg,
                                     jnp.float32)), "cpu")
    b, s = 2, 9
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(b, s, tcfg.d_model)).astype(np.float32))
    fwd = getattr(xlstm, f"{kind}_forward")(p, tcfg, x)
    st = (xlstm.MLSTMState if kind == "mlstm" else xlstm.SLSTMState).zeros(
        b, tcfg, "cpu")
    dec = getattr(xlstm, f"{kind}_decode")
    outs = []
    for t in range(s):
        o, st = dec(p, tcfg, x[:, t:t + 1], st)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), fwd.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
def test_forward_and_decode_match_jax(kind, dt):
    name, jdt, tdt = dt
    jcfg, tcfg = _cfgs(d_model=32, dtype=name)
    # chunk 8 over 21 positions: two whole mLSTM chunks and a short one
    jcfg = dataclasses.replace(jcfg, xlstm=dataclasses.replace(
        jcfg.xlstm, chunk_size=8))
    tcfg = dataclasses.replace(tcfg, xlstm=dataclasses.replace(
        tcfg.xlstm, chunk_size=8))
    jp = getattr(jax_xlstm, f"init_{kind}")(jax.random.PRNGKey(4), jcfg, jdt)
    tp = to_torch(jax.device_get(jp), "cpu")
    b, s = 2, 21
    x = np.random.default_rng(4).normal(size=(b, s, 32)).astype(np.float32)
    tol = 1e-5 if name == "float32" else 2e-2
    want = getattr(jax_xlstm, f"{kind}_forward")(jp, jcfg, as_jax(x, jdt))
    got = getattr(xlstm, f"{kind}_forward")(tp, tcfg, as_torch(x, tdt))
    assert got.dtype == tdt and _rel(got, want) <= tol
    state = "MLSTMState" if kind == "mlstm" else "SLSTMState"
    jst = getattr(jax_xlstm, state).zeros(b, jcfg)
    tst = getattr(xlstm, state).zeros(b, tcfg, "cpu")
    jdec = getattr(jax_xlstm, f"{kind}_decode")
    tdec = getattr(xlstm, f"{kind}_decode")
    for t in range(4):
        want, jst = jdec(jp, jcfg, as_jax(x[:, t:t + 1], jdt), jst)
        got, tst = tdec(tp, tcfg, as_torch(x[:, t:t + 1], tdt), tst)
        assert _rel(got, want) <= tol, t
    assert type(tst)._fields == type(jst)._fields
    for g, w in zip(tst, jst):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(np32(g), np32(w), rtol=tol,
                                   atol=tol * float(np.abs(np32(w)).max()))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_matches_the_jax_tree(kind):
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    want = jax.eval_shape(lambda: getattr(jax_xlstm, f"init_{kind}")(
        jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    got = getattr(xlstm, f"init_{kind}")(torch.Generator().manual_seed(0),
                                         tcfg, torch.bfloat16, lead=(2,))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == sum(len(v) if isinstance(v, dict) else 1
                              for v in got.values())
    for path, w in flat_w:
        g = got
        for key in path:
            g = g[key.key]
        assert tuple(g.shape) == (2,) + tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    if kind == "mlstm":
        assert torch.all(got["b_f"] == 3.0) and torch.all(got["b_i"] == 0)
    else:
        di = xlstm.d_inner(tcfg)
        bg = got["b_gates"][0]
        assert torch.all(bg[2 * di:3 * di] == 3.0)
        assert torch.all(bg[:2 * di] == 0) and torch.all(bg[3 * di:] == 0)
