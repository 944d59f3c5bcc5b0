"""The recurrent, VLM and enc-dec families of the port, held against the
JAX package on the CPU: jamba (Mamba + attention + MoE), xLSTM (mLSTM +
sLSTM), pixtral (a patch-embedding prefix) and whisper (an encoder,
cross-attention and sinusoidal positions).

* ``lm.forward``, ``loss_fn``, ``prefill`` and the serve step for the
  four reduced configs (pixtral with patches, whisper with frames), from
  the JAX parameters carried over by ``lm_params_from_jax``: fp32 within
  5e-5 of the largest |logit| (the JAX package's own decode bound); bf16
  within 3e-2, 5e-2 for jamba (the MoE bound of tests/test_torch_moe.py).
  The stacked decode states after two steps equal the JAX package's
  returned states at the same tolerances, field for field (KV caches,
  Mamba conv windows and SSM states, mLSTM c/n/m, sLSTM c/n/h/m).
  Jamba's experts are read in both packages (the JAX package's through
  an ordered ``jax.debug.callback``): in bf16 a near-tie of two router
  probabilities can send a token to another expert, which moves that
  token's logits by up to 0.41 of the largest (measured at reduced width)
  and, through the recurrent layers, the later tokens of its row.  So
  each row is held up to its first position where the experts differ,
  and that difference must be a near-tie: the JAX package's k-th and
  (k+1)-th router probabilities within NEAR_TIE (measured gaps
  0.001-0.011).
* Decode equals forward in the port for the four families (fp32, 5e-5
  of the largest logit), with two super-blocks of recurrent layers (the
  in-place writes through the stacked states), jamba's experts given room
  for every token (nothing dropped, asserted) and pixtral text only.
* One ``make_train_step`` step (SGD with momentum) of reduced jamba and
  xLSTM against the JAX package's: loss and grad norm at 2e-5, params at
  2e-5, the momentum (the step's gradient) at 1e-5.  SGD, not
  adafactor or Adam: their first step moves a parameter by about
  ``lr * sign(g)``, so where a gradient is ~1e-9 and two summation
  orders give it opposite signs (sLSTM's input-gate biases: at t = 0 the
  stabiliser cancels ``log_i``) the two steps differ by ``2 * lr``.
* ``cross_attention``, ``sinusoid_at`` and ``sinusoidal_positions``
  against the JAX package's; ``init_model``'s tree for the four
  (``encoder``/``enc_norm`` for whisper, fp32 recurrent leaves in bf16);
  every config equal to the JAX registry's; ``python -m
  repro_torch.launch.serve`` and ``launch.train`` for the four on the CPU.

Inputs are seeded numpy arrays handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro.optim import optimizers as jopt
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import (lm_params_from_jax, to_numpy, to_torch,
                                 train_state_from_jax)
from repro_torch.launch import serve, train
from repro_torch.models import attention, layers, lm, moe
from repro_torch.optim import optimizers as topt

from torch_parity import DTYPES, as_jax, as_torch, np32

FAMILIES = ["jamba_1p5_large_398b", "xlstm_1p3b", "pixtral_12b",
            "whisper_medium"]
TOL = {"float32": 5e-5, "bfloat16": 3e-2}
MOE_BF16_TOL = 5e-2
NEAR_TIE = 0.02
ENC_LEN = 16


def _cfgs(arch, dtype="float32", **over):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **over)
    return (dataclasses.replace(jax_get_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


def _tol(arch, dtype):
    if dtype == "bfloat16" and arch.startswith("jamba"):
        return MOE_BF16_TOL
    return TOL[dtype]


def _rel(got, want) -> float:
    got, want = np32(got), np32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _batch(cfg, seed, b=2, s=12):
    """(numpy batch) tokens, and the patches or frames the family takes."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=(b, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["enc_frames"] = rng.normal(
            size=(b, ENC_LEN, cfg.d_model)).astype(np.float32)
    return out


def _jax_batch(batch, dt):
    return {k: jnp.asarray(v) if k == "tokens" else as_jax(v, dt)
            for k, v in batch.items()}


def _torch_batch(batch, dt):
    return {k: torch.from_numpy(v) if k == "tokens" else as_torch(v, dt)
            for k, v in batch.items()}


def _state_fields(stack):
    """The port's stacked states as a flat list of (batch axis, tensor),
    in the order jax flattens the JAX package's (dict keys sorted, named
    tuple fields in order)."""
    return [(1 if path[0][1] == "super" else 0, t)
            for path, nt in tree.flatten_with_path(stack)[0] for t in nt]


class _Routing:
    """The experts every MoE layer picks, in both packages: the port's
    ``moe.route`` spied, the JAX package's through an ordered
    ``jax.debug.callback`` (it fires under jit and scan), with the JAX
    package's fp32 router probabilities."""

    def __init__(self, monkeypatch):
        self.jax, self.torch = [], []
        jreal, treal = jax_moe.route, moe.route

        def jspy(p, x, mcfg):
            out = jreal(p, x, mcfg)
            probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], -1)
            jax.debug.callback(
                lambda i, pr: self.jax.append((np.asarray(i),
                                               np.asarray(pr))),
                out[0], probs, ordered=True)
            return out

        def tspy(p, x, mcfg):
            out = treal(p, x, mcfg)
            self.torch.append(out[0].numpy())
            return out

        monkeypatch.setattr(jax_moe, "route", jspy)
        monkeypatch.setattr(moe, "route", tspy)

    def first_differences(self, rows, length, calls, where):
        """(rows,) each row's first position where the packages' experts
        differ in some layer (``length`` if nowhere), asserting that
        difference is a near-tie.  ``calls``: the routings each package
        made; ``where(call, token)`` -> (row, position) of a routed
        token.  Clears the records."""
        jax.effects_barrier()
        assert len(self.jax) == len(self.torch) == calls
        first = np.full(rows, length)
        gap = {}
        for c, ((jid, jpr), tid) in enumerate(zip(self.jax, self.torch)):
            k = jid.shape[1]
            for t in np.flatnonzero((np.sort(jid, -1)
                                     != np.sort(tid, -1)).any(-1)):
                r, pos = where(c, t)
                if pos < first[r]:
                    ps = np.sort(jpr[t])[::-1]
                    first[r], gap[r] = pos, ps[k - 1] - ps[k]
        for r, g in gap.items():
            assert g <= NEAR_TIE, f"row {r}: experts differ at a gap {g}"
        self.jax.clear()
        self.torch.clear()
        return first


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
def test_forward_loss_prefill_and_serve_match_jax(arch, dt, monkeypatch):
    name, jdt, tdt = dt
    jcfg, tcfg = _cfgs(arch, name)
    tol = _tol(arch, name)
    jp = jax_lm.init_model(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_jax(jax.device_get(jp), "cpu")
    batch = _batch(jcfg, 1)
    jb, tb = _jax_batch(batch, jdt), _torch_batch(batch, tdt)
    b, s = batch["tokens"].shape
    routing = _Routing(monkeypatch)
    n_moe = sum(sp.ff == "moe" for sp in tcfg.layout())

    want, waux = jax.jit(lambda p_, b_: jax_lm.forward(
        p_, jcfg, b_, remat=False))(jp, jb)
    got, gaux = lm.forward(tp, tcfg, tb)
    held = routing.first_differences(b, s, n_moe,
                                     lambda c, t: divmod(t, s))
    assert sum(held) >= b * s // 2, held
    assert tuple(got.shape) == (b, s, tcfg.vocab_size)
    assert got.dtype == torch.float32
    for r in range(b):
        assert _rel(got[r, :held[r]], want[r, :held[r]]) <= tol, r
    assert abs(float(gaux) - float(waux)) <= tol * max(float(waux), 1e-6)
    last = lm.prefill(tp, tcfg, tb)
    for r in np.flatnonzero(held == s):
        assert _rel(last[r], want[r, -1]) <= tol
    wl, wm = jax.jit(lambda p_, b_: jax_lm.loss_fn(
        p_, jcfg, b_, remat=False))(jp, jb)
    gl, gm = lm.loss_fn(tp, tcfg, tb)
    assert abs(float(gl) - float(wl)) <= tol * abs(float(wl))
    assert abs(float(gm["ce"]) - float(wm["ce"])) <= tol * abs(float(wm["ce"]))
    jax.effects_barrier()
    routing.jax.clear()
    routing.torch.clear()

    jserve = jax.jit(jax_lm.make_serve_step(jcfg))
    tserve = lm.make_serve_step(tcfg)
    jstate = jax_lm.init_decode_state(jp, jcfg, b, s,
                                      enc_frames=jb.get("enc_frames"))
    tstate = lm.init_decode_state(tp, tcfg, b, s,
                                  enc_frames=tb.get("enc_frames"))
    if tcfg.is_encdec:
        assert _rel(tstate.enc, jstate.enc) <= tol
    fields = _state_fields(tstate.stack)
    toks = batch["tokens"]
    jl, tl = [], []
    for t in range(s):
        lg, jstate = jserve(jp, jstate, jnp.asarray(toks[:, t:t + 1]))
        jl.append(lg)
        lg, tstate = tserve(tp, tstate, torch.from_numpy(toks[:, t:t + 1]))
        tl.append(lg)
        if t == 1:
            states = [f.clone() for _, f in _state_fields(tstate.stack)]
            want_f = jax.tree_util.tree_leaves(jstate.stack)
    held = routing.first_differences(
        b, s, n_moe * s, lambda c, t: (t, c // n_moe))   # a layer a step
    for r in range(b):
        for t in range(held[r]):
            assert _rel(tl[t][r], jl[t][r]) <= tol, (r, t)
    # after two steps: the stacked states, written in place (the tensors
    # made by init_decode_state), equal the JAX package's
    assert [f for _, f in _state_fields(tstate.stack)] == [
        f for _, f in fields]
    assert len(states) == len(want_f) == len(fields)
    for (axis, _), g, w in zip(fields, states, want_f):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        rows = torch.from_numpy(np.flatnonzero(held > 1))
        g, w = np32(g.index_select(axis, rows)), np.take(np32(w), rows, axis)
        np.testing.assert_allclose(
            g, w, rtol=tol, atol=tol * max(float(np.abs(w).max()), 1e-30))
    assert tstate.pos == s == int(jstate.pos)


DECODE_CASES = [("jamba_1p5_large_398b", 8), ("xlstm_1p3b", 4),
                ("pixtral_12b", None), ("whisper_medium", None)]


@pytest.mark.parametrize("arch,n_layers", DECODE_CASES,
                         ids=[a for a, _ in DECODE_CASES])
def test_decode_matches_forward(arch, n_layers, monkeypatch):
    """The port's own contract, as tests/test_decode_consistency.py holds
    the JAX package's: decode from empty states reproduces the forward
    logits at every position (fp32, 5e-5 of the largest logit)."""
    _, tcfg = _cfgs(arch, **({"num_layers": n_layers} if n_layers else {}))
    if n_layers:
        assert lm.plan_for(tcfg).n_super == 2
    if tcfg.moe is not None:
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=tcfg.moe.num_experts / tcfg.moe.top_k))
    kept = []
    real = moe._positions_in_expert

    def spy(flat_ids, e, cap):
        pos, keep = real(flat_ids, e, cap)
        kept.append(bool(keep.all()))
        return pos, keep

    monkeypatch.setattr(moe, "_positions_in_expert", spy)
    tp = lm.init_model(tcfg, torch.Generator().manual_seed(1), "cpu")
    batch = _torch_batch(_batch(tcfg, 2), torch.float32)
    batch.pop("patch_embeds", None)          # decode is text only
    b, s = batch["tokens"].shape
    full, _ = lm.forward(tp, tcfg, batch)
    step = lm.make_serve_step(tcfg)
    state = lm.init_decode_state(tp, tcfg, b, s,
                                 enc_frames=batch.get("enc_frames"))
    outs = []
    for t in range(s):
        lg, state = step(tp, state, batch["tokens"][:, t:t + 1])
        outs.append(lg)
    assert all(kept), "an expert overflowed: the check needs none"
    assert bool(kept) == (tcfg.moe is not None)
    assert _rel(torch.stack(outs, 1), full) <= 5e-5


@pytest.mark.parametrize("arch", ["jamba_1p5_large_398b", "xlstm_1p3b"])
def test_train_step_matches_jax(arch):
    """One SGD-momentum step from one state carried by
    train_state_from_jax: loss and grad norm at 2e-5, params at 2e-5,
    the momentum at 1e-5."""
    jcfg, tcfg = _cfgs(arch)
    js = jax_lm.init_train_state(jax.random.PRNGKey(0), jcfg,
                                 jopt.sgd(0.1, momentum=0.9))
    ts = train_state_from_jax(jax.device_get(js), "cpu")
    toks = _batch(jcfg, 3, b=4, s=16)["tokens"]
    js, jm = jax.jit(jax_lm.make_train_step(
        jcfg, jopt.sgd(0.1, momentum=0.9)))(js, {"tokens": jnp.asarray(toks)})
    ts, tm = lm.make_train_step(tcfg, topt.sgd(0.1, momentum=0.9))(
        ts, {"tokens": torch.from_numpy(toks)})
    for key in ("loss", "ce", "moe_aux", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= 2e-5 * max(
            1.0, abs(float(jm[key]))), key
    for what, got, want, tol in (("params", ts.params, js.params, 2e-5),
                                 ("momentum", ts.opt_state, js.opt_state,
                                  1e-5)):
        g_l = tree.leaves(to_numpy(got))
        w_l = jax.tree_util.tree_leaves(jax.device_get(want))
        assert len(g_l) == len(w_l)
        for a, w in zip(g_l, w_l):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(w, np.float64), rtol=0,
                                       atol=tol, err_msg=what)


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
def test_cross_attention_and_sinusoids_match_jax(dt):
    name, jdt, tdt = dt
    jcfg, tcfg = _cfgs("whisper_medium", name)
    jp = jax_attn.init_cross_attention(jax.random.PRNGKey(5), jcfg, jdt)
    tp = to_torch(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 19, jcfg.d_model)).astype(np.float32)
    want = jax_attn.cross_attention(jp, jcfg, as_jax(x, jdt),
                                    as_jax(enc, jdt))
    got = attention.cross_attention(tp, tcfg, as_torch(x, tdt),
                                    as_torch(enc, tdt))
    assert got.dtype == tdt
    assert _rel(got, want) <= (1e-5 if name == "float32" else 2e-2)
    for d in (8, 256, 1024):
        np.testing.assert_allclose(
            layers.sinusoidal_positions(1500, d).numpy(),
            np.asarray(jax_layers.sinusoidal_positions(1500, d)),
            rtol=0, atol=2e-4)
        for pos in (0, 1, 447, 1499):
            np.testing.assert_allclose(
                layers.sinusoid_at(pos, d).numpy(),
                np.asarray(jax_layers.sinusoid_at(jnp.int32(pos), d)),
                rtol=0, atol=2e-4)
            np.testing.assert_array_equal(
                layers.sinusoid_at(pos, d).numpy(),
                layers.sinusoidal_positions(1500, d)[pos].numpy())


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_model_matches_the_jax_tree(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    want = jax.eval_shape(
        lambda: jax_lm.init_model(jax.random.PRNGKey(0), jcfg))
    got = lm.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    wl, wt = jax.tree_util.tree_flatten(want)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, got)) == wt
    for g, w in zip(tree.leaves(got), wl):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert ("encoder" in got) == tcfg.is_encdec == ("enc_norm" in got)


def test_configs_match_the_jax_registry():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for reduced in (False, True):
            assert dataclasses.asdict(get_config(arch, reduced)) == \
                dataclasses.asdict(jax_get_config(arch, reduced))


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_and_train_cli_on_cpu(arch, capsys):
    seq = serve.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--sample", "greedy"])
    assert tuple(seq.shape) == (2, 4)
    _, metrics = train.main(["--arch", arch, "--device", "cpu", "--steps",
                             "1", "--batch", "2", "--seq", "16"])
    assert np.isfinite(float(metrics["loss"]))
    out = capsys.readouterr().out
    assert "ms/token" in out and "done." in out


def test_enc_dec_decode_needs_frames():
    _, tcfg = _cfgs("whisper_medium")
    tp = lm.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="enc_frames"):
        lm.init_decode_state(tp, tcfg, 2, 8)
