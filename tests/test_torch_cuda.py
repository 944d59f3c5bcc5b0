"""Tests of the PyTorch port that need an NVIDIA GPU (marker ``cuda``).

They skip where there is no card.  This file imports neither ``jax`` nor
the JAX package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels, tree
from repro_torch.kernels.importance import ops as imp_ops
from repro_torch.kernels.importance.ref import channel_importance_ref
from repro_torch.kernels.masked_merge import ops as mm_ops
from repro_torch.kernels.masked_merge.ref import masked_merge_ref
from repro_torch.kernels.sparse_agg import ops as agg_ops
from repro_torch.kernels.sparse_agg.ref import masked_weighted_sum_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """Skip unless a CUDA card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.parametrize("kernel", ["importance", "sparse_agg",
                                    "masked_merge"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_on_card_matches_plain(kernel, dtype, cuda_device):
    """Each kernel against its plain version on the same CUDA tensors
    (tolerances of the CPU tests; Eq. (5) exact), at a ragged shape; the
    launch count moves by exactly one."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    n, r, c = 7, 257, 513
    x = torch.randn((n, r, c), generator=gen, device=cuda_device)
    y = (x + 0.1 * torch.randn((n, r, c), generator=gen,
                               device=cuda_device)).to(dtype)
    x = x.to(dtype)
    m = (torch.rand((n, 1, c), generator=gen, device=cuda_device)
         > 0.5).to(dtype)
    w = torch.rand((n,), generator=gen, device=cuda_device) + 0.5
    before = kernels.launch_counts()[kernel]
    if kernel == "importance":
        got = imp_ops.channel_importance_batched(x, y)
        want = channel_importance_ref(x.view(n, r, c, 1), y.view(n, r, c, 1))
        torch.testing.assert_close(got, want, rtol=5e-5, atol=1e-5)
    elif kernel == "sparse_agg":
        num, den = agg_ops.masked_weighted_sum(x, m, w)
        wnum, wden = masked_weighted_sum_ref(x.view(n, r, c, 1),
                                             m.view(n, c), w)
        rtol = 5e-3 if dtype == torch.bfloat16 else 3e-5
        torch.testing.assert_close(num, wnum.view(r, c), rtol=rtol,
                                   atol=1e-4)
        torch.testing.assert_close(den, wden.view(r, c), rtol=3e-5,
                                   atol=1e-5)
    else:
        g = x[0].contiguous()
        got = mm_ops.masked_merge(g, y, m)
        want = masked_merge_ref(g.view(r, c, 1), y.view(n, r, c, 1),
                                m.view(n, c))
        assert torch.equal(got, want.view(n, r, c))
        assert torch.equal(got, torch.where(m.bool(), g[None], y))
    torch.cuda.synchronize()
    assert kernels.launch_counts()[kernel] == before + 1


def test_quickstart_rounds_on_card(cuda_device):
    """Two FedDD rounds and one FedAvg round of the quickstart on the card
    go through all three FedDD kernels (and not flash attention), Eq. (5)
    in one launch per partial FedDD round for all six leaves, and keep the
    model there."""
    from repro_torch.quickstart import FEDDD_H, run
    kernels.reset_launch_counts()
    feddd, fedavg, _ = run(2, fedavg_rounds=1, device=cuda_device)
    counts = kernels.launch_counts()
    assert counts.pop("flash_attention") == 0
    assert counts.pop("conv") == 0
    assert all(v > 0 for v in counts.values())
    partial = sum(r.round % FEDDD_H != 0 for r in feddd.history)
    assert counts["masked_merge"] == partial == 2
    assert mm_ops.leaf_counts() == {6: partial}
    assert all(np.isfinite(r.mean_loss) for r in feddd.history)
    assert all(leaf.is_cuda for leaf in tree.leaves(fedavg.global_params))


# (B, S, H, Hkv, hd), causal, window.  bf16 at hd 64-256 takes the sm90
# (tensor-core) route, fp32 and bf16 at hd 16-96 the fma route; every sm90
# head dim has a causal, a windowed and a non-causal case, S mostly not a
# multiple of the 128-query tile.
FLASH_CASES = [((2, 64, 4, 2, 32), True, 24), ((1, 130, 4, 2, 48), True, 0),
               ((1, 100, 8, 8, 16), False, 0), ((2, 333, 8, 2, 64), True, 0),
               ((1, 517, 4, 1, 128), True, 100),
               ((1, 200, 2, 2, 256), False, 37),
               ((1, 333, 8, 2, 192), True, 64),
               ((3, 77, 6, 3, 96), True, 0),
               ((1, 700, 2, 1, 64), True, 130), ((2, 200, 4, 2, 64), False, 0),
               ((1, 300, 4, 2, 128), True, 0), ((2, 129, 2, 1, 128), False, 0),
               ((1, 1100, 4, 2, 128), True, 256),
               ((1, 100, 2, 1, 192), False, 0), ((1, 260, 4, 4, 192), False, 0),
               ((1, 257, 4, 2, 256), True, 0), ((1, 390, 2, 1, 256), True, 70)]


@pytest.mark.parametrize("shape,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_on_card_matches_plain(shape, causal, window, dtype,
                                            cuda_device):
    """The flash kernel against its plain version on the same CUDA
    tensors (3e-5 fp32, 2e-2 bf16, as on the CPU; bf16 also every row
    within max|want|/64), at odd lengths and head dims 16-256; one launch
    per call, on the route ``route`` names."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (gqa_attention_ref,
                                                         worst_row_error)
    b, s, h, hkv, hd = shape
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=cuda_device
                           ).to(dtype) for n in (h, hkv, hkv))
    want_route = ("sm90" if dtype == torch.bfloat16
                  and hd in flash_ops.SM90_HEAD_DIMS else "fma")
    before = kernels.launch_counts()["flash_attention"]
    routes = flash_ops.route_counts()
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = gqa_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert worst_row_error(got, want) <= 1 / 64
    assert kernels.launch_counts()["flash_attention"] == before + 1
    after = flash_ops.route_counts()
    assert {r: after[r] - routes[r] for r in after} == {
        r: int(r == want_route) for r in flash_ops.ROUTES}


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_sm90_reads_strided_inputs(hd, cuda_device):
    """The tensor-core route reads q/k/v views in place through their
    (B, S, H) strides: a (B, H, S, hd)-ordered q and a slice of a fused kv
    give the contiguous inputs' result bit for bit."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    gen = torch.Generator(device=cuda_device).manual_seed(hd)
    q = torch.randn((2, 4, 300, hd), generator=gen, device=cuda_device
                    ).to(torch.bfloat16).transpose(1, 2)
    kv = torch.randn((2, 300, 4, hd), generator=gen, device=cuda_device
                     ).to(torch.bfloat16)
    k, v = kv[:, :, :2], kv[:, :, 2:]
    assert not (q.is_contiguous() or k.is_contiguous())
    got = flash_ops.flash_attention(q, k, v, causal=True, window=90)
    want = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True, window=90)
    assert torch.equal(got, want)


def test_flash_sm90_raises_on_unaligned_stride(cuda_device):
    """A bf16 input the TMA cannot read (an H stride of 66 elements) raises;
    it is not sent to the CUDA-core route."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    base = torch.randn((1, 64, 4, 66), device=cuda_device
                       ).to(torch.bfloat16)
    q = base[..., :64]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="TMA"):
        flash_ops.flash_attention(q, q[:, :, :2], q[:, :, 2:])
    assert kernels.launch_counts()["flash_attention"] == 0


def test_reduced_gemma3_prefill_and_decode_on_card(cuda_device, monkeypatch):
    """A 4-layer reduced gemma3 (fp32) on the card: with the flash
    threshold below the prompt every layer launches the kernel, the
    prefill matches the same model on the CPU (plain version), and
    decode over the prompt reproduces the forward logits."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import attention, lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma3_27b", reduced=True),
                              num_layers=4, param_dtype="float32",
                              compute_dtype="float32")
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 32)
    params = lm.init_model(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), cuda_device)
    cpu_params = tree.tree_map(lambda t: t.cpu(), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 48),
                         generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    got = lm.prefill(params, cfg, {"tokens": toks.to(cuda_device)})
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 4
    want = lm.prefill(cpu_params, cfg, {"tokens": toks})
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
    full, _ = lm.forward(params, cfg, {"tokens": toks[:, :20].to(cuda_device)})
    step = lm.make_serve_step(cfg)
    state = lm.init_decode_state(params, cfg, 2, 20)
    outs = []
    for t in range(20):
        lg, state = step(params, state, toks[:, t:t + 1].to(cuda_device))
        outs.append(lg)
    dec = torch.stack(outs, 1)
    assert float((dec - full).abs().max()) <= 1e-4 * float(full.abs().max())
    assert all(c.k.is_cuda for c in tree.leaves(state.stack))


# (N, leaf, channel axis) of the importance kernel: fc0, (7, 257, 513) and
# the channel-first (B > 1, scalar loads) leaf split the fan-in across a
# cluster (S > 1); the VGG conv and (8, 64, 640) fill the card whole, and
# the MLP's smaller leaves have too few rows to split (S = 1).
IMPORTANCE_CASES = [(10, (784, 100), -1), (10, (100, 64), -1),
                    (10, (64, 10), -1), (7, (257, 513), -1),
                    (16, (3, 3, 512, 512), -1), (8, (64, 640), -1),
                    (5, (40, 1000), 0)]


@pytest.mark.parametrize("n,leaf,axis", IMPORTANCE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_importance_splits_match_plain_and_repeat_bitwise(n, leaf, axis,
                                                          dtype,
                                                          cuda_device):
    """The importance kernel at S = 1 and S > 1 against its plain version
    (rtol 5e-5, atol 1e-5), with and without coverage; a second launch on
    the same inputs gives the same bits; one count per call."""
    from repro_torch.kernels import _lib
    gen = torch.Generator(device=cuda_device).manual_seed(n + len(leaf))
    wo = torch.randn((n, *leaf), generator=gen, device=cuda_device)
    wn = (wo + 0.1 * torch.randn((n, *leaf), generator=gen,
                                 device=cuda_device)).to(dtype)
    wo = wo.to(dtype)
    a, c, b = _lib.split_at(leaf, axis % len(leaf))
    vec = _lib.vector_width(c, wo, wn) if b == 1 else 1
    plan = imp_ops.work_plan(n, a, c, b, imp_ops.sm_count(0), vec)
    if n * -(-c // plan.tile) >= imp_ops.sm_count(0):
        assert plan.splits == 1
    if (n, leaf) == (10, (784, 100)):
        assert plan.splits > 1
    cov = torch.rand((c,), generator=gen, device=cuda_device) + 0.5
    for coverage in (None, cov):
        before = kernels.launch_counts()["importance"]
        got = imp_ops.channel_importance_batched(wo, wn, channel_axis=axis,
                                                 coverage=coverage)
        again = imp_ops.channel_importance_batched(wo, wn, channel_axis=axis,
                                                   coverage=coverage)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["importance"] == before + 2
        want = channel_importance_ref(wo.view(n, a, c, b),
                                      wn.view(n, a, c, b), coverage)
        torch.testing.assert_close(got, want, rtol=5e-5, atol=1e-5)
        assert torch.equal(got, again)


def _agg_case(gen, dev, n, leaf, dtype, dense):
    vals = torch.randn((n, *leaf), generator=gen, device=dev).to(dtype)
    if dense:
        mask = torch.ones((n,) + (1,) * len(leaf), dtype=dtype, device=dev)
    else:
        mask = (torch.rand((n,) + (1,) * (len(leaf) - 1) + leaf[-1:],
                           generator=gen, device=dev) > 0.5).to(dtype)
        mask[..., 0] = 0        # a channel no client uploaded
    w = torch.rand((n,), generator=gen, device=dev) + 0.5
    w[1] = 0.0                  # a client left out of Eq. (4)
    gprev = torch.randn(leaf, generator=gen, device=dev).to(dtype)
    return vals, mask, w, gprev


@pytest.mark.parametrize("n,leaf", [(10, (784, 100)), (10, (100,)),
                                    (10, (64, 10)), (7, (257, 513)),
                                    (20, (3, 3, 8, 24)), (3, (33,))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dense", [False, True], ids=["channel", "ones"])
def test_sparse_agg_mean_mode_is_finish_over_partials_bitwise(
        n, leaf, dtype, dense, cuda_device):
    """On the same CUDA tensors the mean mode equals
    ``finish_masked_mean`` over the partials mode bit for bit, with and
    without a previous global, in the values' dtype and in fp32; both
    modes repeat bitwise; each call counts one launch under its mode."""
    from repro_torch.core.aggregation import finish_masked_mean
    gen = torch.Generator(device=cuda_device).manual_seed(n * 7 + len(leaf))
    vals, mask, w, gprev = _agg_case(gen, cuda_device, n, leaf, dtype, dense)
    kernels.reset_launch_counts()
    num, den = agg_ops.masked_weighted_sum(vals, mask, w)
    num2, den2 = agg_ops.masked_weighted_sum(vals, mask, w)
    assert torch.equal(num, num2) and torch.equal(den, den2)
    calls = 2
    for out_dtype in (dtype, torch.float32):
        for g in (None, gprev):
            got = agg_ops.masked_weighted_mean(vals, mask, w, g, out_dtype)
            again = agg_ops.masked_weighted_mean(vals, mask, w, g, out_dtype)
            calls += 2
            want = finish_masked_mean(num, den, g, out_dtype)
            assert got.dtype == out_dtype
            assert torch.equal(got, want)
            assert torch.equal(got, again)
            if g is not None and not dense:
                assert torch.equal(got[..., 0], g[..., 0].to(out_dtype))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sparse_agg"] == calls
    assert agg_ops.mode_counts() == {"partials": 2, "mean": calls - 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_agg_mean_mode_matches_plain(dtype, cuda_device):
    """The mean mode against its plain version at the FedDD fc0 leaf:
    fp32 at the partials' tolerance (rtol 3e-5, atol 1e-4); bf16 within
    one bf16 ulp (rtol 2**-7), and in fp32 output at 5e-3."""
    from repro_torch.kernels.sparse_agg.ref import masked_weighted_mean_ref
    n, leaf = 10, (784, 100)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    vals, mask, w, gprev = _agg_case(gen, cuda_device, n, leaf, dtype, False)
    for out_dtype in (dtype, torch.float32):
        got = agg_ops.masked_weighted_mean(vals, mask, w, gprev, out_dtype)
        want = masked_weighted_mean_ref(vals.view(n, 784, 100, 1),
                                        mask.view(n, 100), w,
                                        gprev.view(784, 100, 1), out_dtype)
        if dtype == torch.float32:
            rtol = 3e-5
        else:
            rtol = 2.0 ** -7 if out_dtype == torch.bfloat16 else 5e-3
        torch.testing.assert_close(got.float(), want.view(leaf).float(),
                                   rtol=rtol, atol=1e-4)


def test_aggregate_sparse_stacked_launches_one_kernel_per_leaf(cuda_device):
    """Eq. (4) over the MLP's six leaves: six sparse_agg launches in the
    mean mode and no other kernel on the card (no eager finish)."""
    from repro_torch.core import aggregation
    from repro_torch.fl import MLP_SPEC, init_cnn_spec
    gp = init_cnn_spec(MLP_SPEC, seed=1, device=cuda_device)
    n = 10
    stacked = tree.tree_map(lambda x: x[None].repeat(
        (n,) + (1,) * x.ndim).contiguous(), gp)
    masks = tree.tree_map(lambda x: torch.ones(
        (n,) + (1,) * (x.ndim - 2) + x.shape[-1:], device=cuda_device),
        stacked)
    w = torch.ones((n,), device=cuda_device)
    aggregation.aggregate_sparse_stacked(stacked, masks, w, prev_global=gp)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        aggregation.aggregate_sparse_stacked(stacked, masks, w,
                                             prev_global=gp)
        torch.cuda.synchronize()
    leaves = len(tree.leaves(gp))
    assert kernels.launch_counts()["sparse_agg"] == leaves
    assert agg_ops.mode_counts() == {"partials": 0, "mean": leaves}
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("sparse_agg" in nm for nm in names), names


@pytest.mark.parametrize("n,leaf,mask_shape", [
    (4, (8, 16), (8, 1)), (5, (6, 3, 10), (6, 1, 1)), (17, (12, 7), (12, 1))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_agg_channel_first_matches_plain(n, leaf, mask_shape, dtype,
                                                cuda_device):
    """A mask along a leading channel axis (B > 1: one mask value per row
    of B contiguous elements, read as vectors where V divides B) in both
    modes against the plain versions; N = 17 takes two passes of the
    client loop."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.sparse_agg.ref import masked_weighted_mean_ref
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    vals = torch.randn((n, *leaf), generator=gen, device=cuda_device
                       ).to(dtype)
    mask = (torch.rand((n, *mask_shape), generator=gen, device=cuda_device)
            > 0.5).to(dtype)
    w = torch.rand((n,), generator=gen, device=cuda_device) + 0.5
    gprev = torch.randn(leaf, generator=gen, device=cuda_device).to(dtype)
    (a, c, b), mc = _lib.mask_view(leaf, mask_shape)
    assert b > 1 and mc == c
    num, den = agg_ops.masked_weighted_sum(vals, mask, w)
    wnum, wden = masked_weighted_sum_ref(vals.view(n, a, c, b),
                                         mask.view(n, c), w)
    rtol = 5e-3 if dtype == torch.bfloat16 else 3e-5
    torch.testing.assert_close(num, wnum.view(leaf), rtol=rtol, atol=1e-4)
    torch.testing.assert_close(den, wden.view(leaf), rtol=3e-5, atol=1e-5)
    got = agg_ops.masked_weighted_mean(vals, mask, w, gprev, torch.float32)
    want = masked_weighted_mean_ref(vals.view(n, a, c, b), mask.view(n, c),
                                    w, gprev.view(a, c, b), torch.float32)
    torch.testing.assert_close(got, want.view(leaf), rtol=rtol, atol=1e-4)


MLP_LEAVES = [(100,), (784, 100), (64,), (100, 64), (10,), (64, 10)]
# the channel counts of the divisor sweep: 1 (an all-ones mask shape),
# below and above a vector, primes, the MLP's, and past 4096
SWEEP_C = [1, 3, 7, 10, 100, 257, 513, 4097]


def _merge_leaf(gen, dev, n, leaf, dtype, axis=-1, kind="binary"):
    """(G, L, mask) of one leaf on the card: a binary, fractional or
    all-ones channel mask along ``axis``."""
    g = torch.randn(leaf, generator=gen, device=dev).to(dtype)
    loc = torch.randn((n, *leaf), generator=gen, device=dev).to(dtype)
    ax = axis % len(leaf)
    if kind == "ones":
        mshape = (n,) + (1,) * len(leaf)
    else:
        mshape = (n,) + tuple(s if i == ax else 1 for i, s in enumerate(leaf))
    m = torch.rand(mshape, generator=gen, device=dev)
    m = (m > 0.5 if kind == "binary" else
         torch.ones_like(m) if kind == "ones" else m).to(dtype)
    return g, loc, m


def _merge_plain(g, loc, m):
    from repro_torch.kernels import _lib
    n = loc.shape[0]
    acb, mask_c = _lib.mask_view(loc.shape[1:], m.shape[1:])
    return masked_merge_ref(g.reshape(acb), loc.reshape((n,) + acb),
                            m.reshape(n, mask_c)).view(loc.shape)


def _merge_group_exact(gs, ls, ms, launches):
    """One group call: each leaf equals the plain version bit for bit
    (NaN where it has NaN), with ``launches`` launches counted."""
    before = kernels.launch_counts()["masked_merge"]
    got = mm_ops.masked_merge_many(gs, ls, ms)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["masked_merge"] == before + launches
    for out, g, loc, m in zip(got, gs, ls, ms):
        want = _merge_plain(g, loc, m)
        assert out.dtype == loc.dtype and out.shape == loc.shape
        torch.testing.assert_close(out, want, rtol=0, atol=0, equal_nan=True)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_merge_group_on_card_matches_plain_at_the_mlp(dtype,
                                                             cuda_device):
    """The MLP's six leaves (N = 10, channel-last masks): one launch that
    merged six leaves, every leaf ``torch.equal`` to the plain version and
    a select of G and L."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    cases = [_merge_leaf(gen, cuda_device, 10, leaf, dtype)
             for leaf in MLP_LEAVES]
    gs, ls, ms = (list(t) for t in zip(*cases))
    kernels.reset_launch_counts()
    got = _merge_group_exact(gs, ls, ms, 1)
    assert mm_ops.leaf_counts() == {6: 1}
    for out, g, loc, m in zip(got, gs, ls, ms):
        assert torch.equal(out, torch.where(m.bool(), g[None], loc))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_merge_group_divisor_sweep(dtype, cuda_device):
    """C over SWEEP_C, each channel-last (B = 1) with binary and fractional
    masks, channel-first (B > 1) and all-ones: 32 leaves in one launch,
    each exact against the plain version.  The (8, C) leaves take vector
    widths 1 to 16 bytes by C, and 9 clients in three chunks."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    cases = []
    for c in SWEEP_C:
        cases += [_merge_leaf(gen, cuda_device, 9, (8, c), dtype),
                  _merge_leaf(gen, cuda_device, 3, (2, c), dtype,
                              kind="fraction"),
                  _merge_leaf(gen, cuda_device, 4, (c, 6), dtype, axis=0),
                  _merge_leaf(gen, cuda_device, 2, (c, 3), dtype,
                              kind="ones")]
    assert len(cases) == mm_ops.MAX_LEAVES
    _merge_group_exact(*(list(t) for t in zip(*cases)), 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_merge_misaligned_views_stay_exact(dtype, cuda_device):
    """G and L, or the mask, as views one element into their storage: the
    vector width falls to 1 (the plan says so) and the merge stays
    exact."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    n, leaf = 10, (784, 100)
    g, loc, m = _merge_leaf(gen, cuda_device, n, leaf, dtype)
    gbuf = torch.empty(g.numel() + 1, dtype=dtype, device=cuda_device)
    lbuf = torch.empty(loc.numel() + 1, dtype=dtype, device=cuda_device)
    mbuf = torch.empty(m.numel() + 1, dtype=dtype, device=cuda_device)
    g1 = gbuf[1:].view(leaf).copy_(g)
    l1 = lbuf[1:].view(loc.shape).copy_(loc)
    m1 = mbuf[1:].view(m.shape).copy_(m)
    spec = mm_ops.LeafSpec(dtype, n, (784, 100, 1), 100,
                           (g1.data_ptr(), l1.data_ptr(), 0), m.data_ptr())
    assert mm_ops.leaf_plan(spec).vec == 1
    spec = spec._replace(addrs=(g.data_ptr(), loc.data_ptr(), 0),
                         mask_addr=m1.data_ptr())
    assert mm_ops.leaf_plan(spec).vec == 1
    want = _merge_plain(g, loc, m)
    for args in ((g1, l1, m), (g, loc, m1), (g1, l1, m1)):
        assert torch.equal(mm_ops.masked_merge(*args), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_merge_fractional_mask_and_nan_stay_exact(dtype, cuda_device):
    """A fractional mask gives the plain version's bits (no FMA
    contraction), and a NaN or inf in L where the mask is 1 gives NaN, as
    the plain version does (the blend is no select)."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    g, loc, m = _merge_leaf(gen, cuda_device, 10, (784, 100), dtype,
                            kind="fraction")
    m[0, 0, 5] = 1.0
    loc[0, 3, 5], loc[0, 4, 5] = float("nan"), float("inf")
    (out,) = _merge_group_exact([g], [loc], [m], 1)
    assert torch.isnan(out[0, 3:5, 5]).all()


def test_masked_merge_33_leaves_take_two_launches(cuda_device):
    """33 leaves of one dtype: two launches, of 32 and 1 leaves; a bf16
    leaf among fp32 ones takes a launch of its own."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    cases = [_merge_leaf(gen, cuda_device, 3, (5 + i, 12), torch.float32)
             for i in range(33)]
    kernels.reset_launch_counts()
    _merge_group_exact(*(list(t) for t in zip(*cases)), 2)
    assert mm_ops.leaf_counts() == {1: 1, 32: 1}
    cases[7] = _merge_leaf(gen, cuda_device, 3, (9, 12), torch.bfloat16)
    _merge_group_exact(*(list(t) for t in zip(*cases[:4] + cases[6:9])), 2)


# ------------------------------------------------- slice 6: C1, C2, C4, A8-9

def test_trainer_loss_on_card_is_the_python_mean(cuda_device, monkeypatch):
    """The mean loss is the per-step losses' Python-float sum divided on
    the host, as the JAX package divides: bit-equal to ``sum / steps`` of
    the same losses (a division by the Python int on the card would
    multiply by its reciprocal, an ulp off for some sums)."""
    from repro_torch import prng
    from repro_torch.data import make_dataset, partition_noniid_b
    from repro_torch.fl import MLP_SPEC, init_cnn_spec, models
    train, _ = make_dataset("mnist", num_train=3000, num_test=10)
    parts = partition_noniid_b(train, 10, seed=0)
    ltf = models.make_local_train_fn(MLP_SPEC, train, parts, flatten=True,
                                     lr=0.1, device=cuda_device)
    params = init_cnn_spec(MLP_SPEC, device=cuda_device)
    seen = []
    ce = models._ce

    def recording_ce(logits, y):
        out = ce(logits, y)
        seen.append(float(out.detach()))
        return out

    monkeypatch.setattr(models, "_ce", recording_ce)
    for i in range(10):
        seen.clear()
        _, loss = ltf(params, i, prng.fold_in(prng.PRNGKey(0), i))
        assert isinstance(loss, float) and len(seen) > 1
        total = 0.0
        for v in seen:
            total += v
        assert loss == total / len(seen)


def test_rotary_exponents_on_card_are_true_quotients(cuda_device):
    """At nemotron-4-340b's rotary_dim of 96 (and the other assigned head
    dims) the exponents equal numpy's float32 true division bit for bit."""
    from repro_torch.models.layers import rotary_exponents
    for dim in (96, 64, 128, 192, 256, 46):
        got = rotary_exponents(dim, cuda_device).cpu().numpy()
        want = (np.arange(0, dim, 2, dtype=np.float32) / np.float32(dim))
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), dim


def test_unembed_softcap_on_card_divides_truly(cuda_device):
    """``logits / softcap`` on the card is the true quotient (a division by
    a tensor), the same bits as dividing by a 0-d card tensor."""
    from repro_torch.models import layers
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    table = torch.randn((4096, 64), generator=gen, device=cuda_device)
    x = torch.randn((3, 64), generator=gen, device=cuda_device)
    got = layers.unembed({"table": table}, x, softcap=30.0)
    logits = torch.matmul(x, table.t())
    want = torch.tanh(logits / torch.tensor(30.0, device=cuda_device)) * 30.0
    assert torch.equal(got, want)


def test_kernels_follow_their_tensors_to_a_second_card(cuda_device):
    """Tensors on cuda:1 while cuda:0 is current: every kernel launches on
    cuda:1's stream under a guard and matches its plain version there.
    Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (the launch's device and stream "
                    "are CPU-tested in tests/test_torch_kernels.py)")
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import gqa_attention_ref
    from repro_torch.kernels.sparse_agg.ref import masked_weighted_mean_ref
    dev1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    gen = torch.Generator(device=dev1).manual_seed(11)
    n, r, c = 5, 64, 100
    x = torch.randn((n, r, c), generator=gen, device=dev1)
    y = x + 0.1 * torch.randn((n, r, c), generator=gen, device=dev1)
    m = (torch.rand((n, 1, c), generator=gen, device=dev1) > 0.5).float()
    w = torch.rand((n,), generator=gen, device=dev1) + 0.5
    got = imp_ops.channel_importance_batched(x, y)
    torch.testing.assert_close(got, channel_importance_ref(
        x.view(n, r, c, 1), y.view(n, r, c, 1)), rtol=5e-5, atol=1e-5)
    got = agg_ops.masked_weighted_mean(y, m, w, x[0], torch.float32)
    torch.testing.assert_close(got, masked_weighted_mean_ref(
        y.view(n, r, c, 1), m.view(n, c), w, x[0].view(r, c, 1),
        torch.float32).view(r, c), rtol=3e-5, atol=1e-4)
    got = mm_ops.masked_merge(x[0].contiguous(), y, m)
    assert got.device == dev1
    assert torch.equal(got, torch.where(m.bool(), x[0][None], y))
    q = torch.randn((1, 300, 4, 128), generator=gen, device=dev1
                    ).to(torch.bfloat16)
    got = flash_ops.flash_attention(q, q, q)
    torch.testing.assert_close(got.float(),
                               gqa_attention_ref(q, q, q).float(),
                               rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize(dev1)
    assert torch.cuda.current_device() == 0


def test_masked_merge_takes_a_client_leaf_past_2_31_elements(cuda_device):
    """One bf16 client leaf of (32769, 65536) = 2,147,549,184 elements
    (split into descriptors under 2**31) equals ``torch.where(M > 0, G,
    L)`` exactly."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    leaf = (32769, 65536)
    g = torch.randn(leaf, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    loc = torch.randn((1,) + leaf, generator=gen, device=cuda_device,
                      dtype=torch.bfloat16)
    m = (torch.rand((1, 1, leaf[1]), generator=gen, device=cuda_device)
         > 0.5).to(torch.bfloat16)
    kernels.reset_launch_counts()
    out = mm_ops.masked_merge(g, loc, m)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["masked_merge"] == 1
    assert mm_ops.leaf_counts() == {2: 1}          # two descriptors
    assert torch.equal(out, torch.where(m > 0, g[None], loc))


def test_prng_on_card_equals_the_jax_constants(cuda_device):
    """chip_smoke's PRNG phase on the card: Random123's vectors, keys,
    bits, uniforms and permutations equal jax.random's (constants), the
    normal within its ulps."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.prng_phase(cuda_device)
    assert out["normal_max_ulps"] <= smoke.NORMAL_ULPS


@pytest.mark.parametrize("scheme", ["feddd", "random"])
def test_engine_step_with_int8_on_card_equals_cpu(scheme, cuda_device):
    """One engine step with the round key and CommConfig(auto, 8) on the
    card and on the CPU: equal densities, wire overhead and int8-decoded
    uploads; parameters within 1e-5."""
    from repro_torch import prng
    from repro_torch.comm import CommConfig, quantize
    from repro_torch.core.round_engine import (BatchedRoundEngine,
                                               stack_pytrees)
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.fl import MLP_SPEC, init_cnn_spec
    rng = np.random.default_rng(2)
    gp = init_cnn_spec(MLP_SPEC, seed=1, device="cpu")
    old = stack_pytrees([tree.tree_map(lambda v: v + torch.from_numpy(
        rng.normal(0, 0.05, v.shape).astype(np.float32)), gp)
        for _ in range(10)])
    new = tree.tree_map(lambda v: v + torch.from_numpy(
        rng.normal(0, 0.02, v.shape).astype(np.float32)), old)
    rates, weights = rng.uniform(0, 0.8, 10), rng.integers(100, 900, 10)
    rk = prng.split(prng.PRNGKey(3))[1]
    engine = BatchedRoundEngine(SelectionConfig(scheme),
                                CommConfig(codec="auto", qbits=8))
    card = lambda t: tree.tree_map(lambda v: v.to(cuda_device), t)  # noqa
    kernels.reset_launch_counts()
    got = engine.step(card(old), card(new), card(gp), rates, weights, rk,
                      full_round=False)
    want = engine.step(old, new, gp, rates, weights, rk, full_round=False)
    assert torch.equal(got.densities.cpu(), want.densities)
    assert torch.equal(got.wire_overhead.cpu(), want.wire_overhead)
    for a, b in zip(tree.leaves(quantize.quantize_dequantize_stacked(
            card(new), rk, 8)),
            tree.leaves(quantize.quantize_dequantize_stacked(new, rk, 8))):
        assert torch.equal(a.cpu(), b)
    for part in ("global_params", "client_params"):
        for a, b in zip(tree.leaves(getattr(got, part)),
                        tree.leaves(getattr(want, part))):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    counts = kernels.launch_counts()
    assert counts["importance"] == (6 if scheme == "feddd" else 0)
    assert counts["sparse_agg"] == 6 and counts["masked_merge"] == 1


def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("leaf", [(784, 100), (100, 64), (64, 10), (100,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_importance_at_one_client_matches_plain(leaf, dtype, cuda_device):
    """The per-client loop's launch: the importance kernel at N = 1 (each
    MLP leaf, with and without a coverage vector) against its plain
    version, one launch a call; at the MLP the fan-in split is the
    engine's (N = 10), so both sum in one order."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    wo = torch.randn((1,) + leaf, generator=gen, device=cuda_device)
    wn = (wo + 0.1 * torch.randn((1,) + leaf, generator=gen,
                                 device=cuda_device)).to(dtype)
    wo = wo.to(dtype)
    a, c, b = (leaf[0] if len(leaf) == 2 else 1), leaf[-1], 1
    for cov in (None, torch.rand((c,), generator=gen, device=cuda_device)
                + 0.5):
        before = kernels.launch_counts()["importance"]
        got = imp_ops.channel_importance_batched(wo, wn, coverage=cov)
        assert kernels.launch_counts()["importance"] == before + 1
        want = channel_importance_ref(wo.view(1, a, c, b),
                                      wn.view(1, a, c, b), cov)
        torch.testing.assert_close(got, want, rtol=5e-5, atol=1e-5)
    sms = imp_ops.sm_count(wo.device)
    vec = 4 if c % 4 == 0 else 2
    assert (imp_ops.work_plan(1, a, c, b, sms, vec).splits
            == imp_ops.work_plan(10, a, c, b, sms, vec).splits)


def test_loop_matches_the_engine_on_card(cuda_device):
    """Three quickstart rounds through the per-client loop (track_epsilon)
    and the engine on the card: the loop's launches (importance at N = 1
    per client and leaf, Eq. (4) once a leaf, Eq. (5) once a client and
    partial round), equal rates and clock, finite epsilons; masks that
    differ only at near-ties of the k-th score, and while they agree,
    equal parameters."""
    smoke = _smoke()
    from repro_torch.quickstart import run
    eng_scores, loop_scores = [], []
    with smoke.recorded_scores(eng_scores):
        eng, _, _ = run(3, fedavg_rounds=0, device=cuda_device)
    with smoke.recorded_scores(loop_scores):
        kernels.reset_launch_counts()
        loop, _, _ = run(3, fedavg_rounds=0, batched=False,
                         track_epsilon=True, device=cuda_device)
        counts = kernels.launch_counts()
        merged = mm_ops.leaf_counts()
    assert counts == dict(importance=180, sparse_agg=18, masked_merge=30,
                          flash_attention=0, conv=0)
    assert merged == {6: 30}
    assert all(np.isfinite(r.epsilon) and r.epsilon >= 0
               for r in loop.history)
    for lr, er in zip(loop.history, eng.history):
        np.testing.assert_array_equal(lr.dropout_rates, er.dropout_rates)
        assert lr.sim_time == er.sim_time
    first, _, _ = smoke.mask_agreement(eng.history, eng_scores, loop_scores,
                                       10, 6)
    if first is None:
        for a, b in zip(tree.leaves(loop.global_params),
                        tree.leaves(eng.global_params)):
            assert torch.equal(a, b)


def test_obs_adds_no_synchronising_calls_on_card(cuda_device, tmp_path):
    """Two quickstart rounds on the engine with obs off and with a JSONL
    log, after a warm-up run: the same number of synchronising CUDA calls
    (``set_sync_debug_mode("warn")``), equal records and parameters."""
    import dataclasses
    import warnings
    from repro_torch.obs import ObsConfig
    from repro_torch.quickstart import run
    runs, syncs = [], []
    # the first run under the debug mode takes the one torch-internal
    # synchronising call it sees first in a process: a warm-up, not counted
    for cfg in (ObsConfig(), ObsConfig(),
                ObsConfig(jsonl_path=str(tmp_path / "r.jsonl"))):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                runs.append(run(2, fedavg_rounds=0, obs=cfg,
                                device=cuda_device)[0])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    runs, syncs = runs[1:], syncs[1:]
    assert syncs[0] > 0 and syncs[0] == syncs[1]
    fields = [[dataclasses.asdict(r) | {
        "host_wall_time": None, "dropout_rates": r.dropout_rates.tolist()}
        for r in res.history] for res in runs]
    assert fields[0] == fields[1]
    for a, b in zip(tree.leaves(runs[0].global_params),
                    tree.leaves(runs[1].global_params)):
        assert torch.equal(a, b)


def _scan_fixture(dev, n=8, seed=0):
    """A small MLP (20-12-5) over ``n`` clients with 32 seeded samples
    each, one vmapped full-shard SGD step a round -> (params, telemetry,
    batched_train_fn), on the card."""
    import torch.nn.functional as F
    from repro_torch import prng
    from repro_torch.core.allocation import ClientTelemetry
    from repro_torch.core.round_engine import make_batched_train_fn
    from repro_torch.fl import apply_spec, init_cnn_spec, model_bytes
    spec = [("fc", 20, 12), ("fc", 12, 5)]
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.normal(size=(n, 32, 20)).astype(
        np.float32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, 5, (n, 32))).to(dev)
    params = init_cnn_spec(spec, prng.PRNGKey(seed), device=dev)
    tel = ClientTelemetry(
        model_bytes=np.full(n, float(model_bytes(params))),
        uplink_rate=rng.uniform(1e3, 5e3, n),
        downlink_rate=rng.uniform(5e3, 2e4, n),
        compute_latency=rng.uniform(1.0, 5.0, n),
        num_samples=rng.integers(10, 50, n).astype(float),
        label_coverage=rng.uniform(0.5, 1.0, n), train_loss=np.ones(n))

    def step(p, x, y):
        g, l = torch.func.grad_and_value(
            lambda q: F.cross_entropy(apply_spec(q, spec, x), y))(p)
        return tree.tree_map(lambda w, gw: w - 0.1 * gw, p, g), l

    return params, tel, make_batched_train_fn(step, (xs, ys))


@pytest.mark.parametrize("scheme,k", [("feddd", 4), ("feddd", 3),
                                      ("oort", 4), ("fedcs", 2)])
def test_scanned_equals_per_round_on_card(scheme, k, cuda_device):
    """7 rounds scanned at K against the per-round fused path on the card
    (allocator "jax"): records, global and client params bit for bit, and
    the same kernel launches."""
    import dataclasses
    from repro_torch.core.protocol import FedDDServer, ProtocolConfig
    params, tel, bt = _scan_fixture(cuda_device)
    runs = []
    for rpd in (1, k):
        srv = FedDDServer(params, ProtocolConfig(
            scheme=scheme, rounds=7, a_server=0.6, h=3, seed=0,
            allocator="jax", rounds_per_dispatch=rpd), tel,
            device=cuda_device)
        kernels.reset_launch_counts()
        res = srv.run(batched_train_fn=bt)
        runs.append((srv, res, kernels.launch_counts()))
    (sa, ra, ca), (sb, rb, cb) = runs
    assert ca == cb and ca["sparse_agg"] == 4 * 7
    fields = [[dataclasses.asdict(r) | {
        "host_wall_time": None, "dropout_rates": r.dropout_rates.tolist()}
        for r in res.history] for res in (ra, rb)]
    assert fields[0] == fields[1]
    for a, b in zip(tree.leaves(ra.global_params),
                    tree.leaves(rb.global_params)):
        assert a.is_cuda and torch.equal(a, b)
    for x, y in zip(sa.clients, sb.clients):
        for a, b in zip(tree.leaves(x.params), tree.leaves(y.params)):
            assert torch.equal(a, b)
    if scheme == "feddd":
        assert ca["importance"] == 4 * 7
    else:
        assert any(r.participants < 8 for r in rb.history)


def test_scanned_chunk_makes_no_synchronising_call(cuda_device):
    """``BatchedRoundEngine.run`` for a K = 5 chunk (FedDD, allocator on
    the card) makes no synchronising CUDA call from its entry to its
    return, after an uncounted warm-up chunk; the trace is fetched
    after."""
    from repro_torch import prng
    from repro_torch.core import allocation, round_engine
    params, tel, bt = _scan_fixture(cuda_device, n=6)
    n = tel.num_clients
    stel = round_engine.ScanTelemetry.from_host(tel, cuda_device)
    state = round_engine.ScanState(
        round_engine.stack_pytrees([params] * n),
        tree.tree_map(torch.clone, params),
        torch.ones(n, device=cuda_device), torch.zeros(n, device=cuda_device),
        prng.PRNGKey(0), torch.zeros((), device=cuda_device))
    kw = dict(num_rounds=5, batched_train_fn=bt,
              weights=allocation.stage(tel.num_samples, cuda_device), h=3,
              a_server=0.6, d_max=0.8, delta=1.0,
              global_model_bytes=float(tel.model_bytes[0]))
    engine = round_engine.BatchedRoundEngine()
    counts = [{}, {}]
    for t_start, counted in zip((1, 6), counts):
        torch.cuda.synchronize()
        with _smoke()._count_syncs(counted, cuda_device):
            state, trace = engine.run(state, stel, t_start=t_start, **kw)
    assert counts[1] == {"syncs": 0, "where": {}}
    host = trace.to_host()
    assert host.losses.shape == (5, n) and np.isfinite(host.losses).all()
    assert host.next_dropout.max() > 0


# the client-batched convolutions at the benchmark cell's three CNN2
# convs (100 clients x 50 images), CNN1's 5x5 convs and VGG convs at
# 256-512 channels: (N, B, C, O, H, k)
CONV_SHAPES = [(100, 50, 3, 16, 32, 3), (100, 50, 16, 32, 16, 3),
               (100, 50, 32, 64, 8, 3), (10, 32, 1, 10, 16, 5),
               (10, 32, 10, 20, 8, 5), (4, 16, 512, 512, 2, 3),
               (3, 4, 40, 70, 5, 3)]


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv_passes_match_plain_in_float64(shape, cuda_device):
    """Each pass of the kernels (float32, inputs in the main path's NHWC
    and HWIO views) against ``ref.py`` in float64: the error's norm at
    most 1e-5 of the output's."""
    from repro_torch.kernels.conv import ops, ref
    n, b, c, o, h, k = shape
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = torch.randn((n, b, h, h, c), generator=gen,
                    device=cuda_device).permute(0, 1, 4, 2, 3)
    w = torch.randn((n, k, k, c, o), generator=gen,
                    device=cuda_device).permute(0, 4, 3, 1, 2)
    g = torch.randn((n, b, o, h, h), generator=gen, device=cuda_device)
    xd, wd, gd = x.double(), w.double(), g.double()
    for got, want in ((ops.fprop_batched(x, w), ref.conv_fprop_ref(xd, wd)),
                      (ops.dgrad_batched(g, w), ref.conv_dgrad_ref(gd, wd)),
                      (ops.wgrad_batched(x, g, k),
                       ref.conv_wgrad_ref(xd, gd, k))):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert (got.double() - want).norm() <= 1e-5 * want.norm()


def _cnn2_step(dev, n, b):
    """(one vmapped CNN2 client step as the benchmark's trainer writes
    it, stacked params, inputs) for ``n`` clients of ``b`` images."""
    from repro_torch.core.round_engine import make_batched_train_fn
    from repro_torch.fl import models
    spec = models.CNN2_SPEC
    gen = torch.Generator(device=dev).manual_seed(3)
    params = models.init_cnn_spec(spec, seed=1, device=dev)
    stacked = tree.tree_map(lambda t: t + 0.01 * torch.randn(
        (n,) + t.shape, generator=gen, device=dev), params)
    x = torch.rand((n, b, 32, 32, 3), generator=gen, device=dev)
    y = torch.randint(0, 10, (n, b), generator=gen, device=dev)

    def client_step(p, xb, yb):
        gr, l = torch.func.grad_and_value(
            lambda q: models._ce(models.apply_spec(q, spec, xb), yb))(p)
        return tree.tree_map(lambda u, v: u - 0.05 * v, p, gr), l

    return make_batched_train_fn(client_step, (x, y)), stacked


def test_vmapped_cnn2_step_on_card_takes_the_conv_kernels(cuda_device):
    """One vmapped CNN2 step of the cell (100 clients x 50 images): 3
    forward, 2 input-gradient (the images take none), 3 weight-gradient
    launches and 3 sums of their splits (every CNN2 weight gradient
    splits on 132 SMs); no ATen convolution is dispatched; two runs are
    bit-equal."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels.conv import ops
    step, stacked = _cnn2_step(cuda_device, 100, 50)
    seen = []

    class Convs(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "convolution" in func.__name__:
                seen.append(func.__name__)
            return func(*args, **(kwargs or {}))

    first = step(stacked, None)
    kernels.reset_launch_counts()
    with Convs():
        second = step(stacked, None)
    torch.cuda.synchronize()
    assert ops.route_counts() == {"fprop": 3, "dgrad": 2, "wgrad": 3,
                                  "wgrad_reduce": 3}
    assert seen == []
    for a, b in zip(tree.leaves(first[0]) + [first[1]],
                    tree.leaves(second[0]) + [second[1]]):
        assert torch.equal(a, b)


def test_conv_kernels_refuse_other_dtypes_on_card(cuda_device):
    from repro_torch.kernels.conv import ops
    x = torch.zeros((2, 1, 3, 4, 4), dtype=torch.bfloat16,
                    device=cuda_device)
    w = torch.zeros((2, 5, 3, 3, 3), dtype=torch.bfloat16,
                    device=cuda_device)
    with pytest.raises(TypeError):
        ops.fprop_batched(x, w)


def _conv_scan_fixture(dev, n=8, seed=0):
    """``_scan_fixture`` with a small conv net (two SAME 3x3 convs with
    pools and a dense head) over 8 x 8 x 3 images: its vmapped step takes
    the conv kernels."""
    from repro_torch import prng
    from repro_torch.core.allocation import ClientTelemetry
    from repro_torch.core.round_engine import make_batched_train_fn
    from repro_torch.fl import apply_spec, init_cnn_spec, model_bytes
    from repro_torch.fl.models import _ce
    spec = [("conv", 3, 8, 3), ("pool",), ("conv", 8, 16, 3), ("pool",),
            ("fc", 64, 5)]
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.normal(size=(n, 32, 8, 8, 3)).astype(
        np.float32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, 5, (n, 32))).to(dev)
    params = init_cnn_spec(spec, prng.PRNGKey(seed), device=dev)
    tel = ClientTelemetry(
        model_bytes=np.full(n, float(model_bytes(params))),
        uplink_rate=rng.uniform(1e3, 5e3, n),
        downlink_rate=rng.uniform(5e3, 2e4, n),
        compute_latency=rng.uniform(1.0, 5.0, n),
        num_samples=rng.integers(10, 50, n).astype(float),
        label_coverage=rng.uniform(0.5, 1.0, n), train_loss=np.ones(n))

    def step(p, x, y):
        g, l = torch.func.grad_and_value(
            lambda q: _ce(apply_spec(q, spec, x), y))(p)
        return tree.tree_map(lambda w, gw: w - 0.1 * gw, p, g), l

    return params, tel, make_batched_train_fn(step, (xs, ys))


def test_scanned_equals_per_round_on_card_through_the_conv_kernels(
        cuda_device):
    """``tests/test_torch_scan.py``'s scanned-equals-per-round on the
    card with a conv net: FedDD, 7 rounds at K = 4 against K = 1, records,
    global and client params bit for bit, the conv kernels launched as
    often on both paths (7 steps of 2 forward, 1 input-gradient and 2
    weight-gradient passes, and their split sums)."""
    import dataclasses
    from repro_torch.core.protocol import FedDDServer, ProtocolConfig
    from repro_torch.kernels.conv import ops
    params, tel, bt = _conv_scan_fixture(cuda_device)
    runs = []
    for rpd in (1, 4):
        srv = FedDDServer(params, ProtocolConfig(
            scheme="feddd", rounds=7, a_server=0.6, h=3, seed=0,
            allocator="jax", rounds_per_dispatch=rpd), tel,
            device=cuda_device)
        kernels.reset_launch_counts()
        res = srv.run(batched_train_fn=bt)
        runs.append((srv, res, ops.route_counts()))
    (sa, ra, ca), (sb, rb, cb) = runs
    assert ca == cb
    assert (ca["fprop"], ca["dgrad"], ca["wgrad"]) == (14, 7, 14)
    fields = [[dataclasses.asdict(r) | {
        "host_wall_time": None, "dropout_rates": r.dropout_rates.tolist()}
        for r in res.history] for res in (ra, rb)]
    assert fields[0] == fields[1]
    for a, b in zip(tree.leaves(ra.global_params),
                    tree.leaves(rb.global_params)):
        assert a.is_cuda and torch.equal(a, b)
    for x, y in zip(sa.clients, sb.clients):
        for a, b in zip(tree.leaves(x.params), tree.leaves(y.params)):
            assert torch.equal(a, b)


def test_clip_aggregation_launches_the_partials_mode(cuda_device):
    """robust_agg "clip" reaches sparse_agg's partials mode on the card
    (one launch a leaf) and agrees with the plain version on the CPU;
    "trimmed" launches no kernel."""
    from repro_torch.core import aggregation
    gen = torch.Generator().manual_seed(3)
    n = 7
    shapes = [(20, 12), (12,), (12, 5), (5,)]
    vals = [torch.randn((n,) + s, generator=gen) for s in shapes]
    vals[0][1] *= 40.0
    masks = [(torch.rand((n,) + (1,) * (len(s) - 1) + s[-1:],
                         generator=gen) > 0.3).float() for s in shapes]
    prev = [torch.randn(s, generator=gen) for s in shapes]
    w = np.arange(1.0, n + 1.0)
    want = aggregation.aggregate_sparse_stacked(vals, masks, w,
                                                prev_global=prev,
                                                robust="clip:2.0")
    kernels.reset_launch_counts()
    got = aggregation.aggregate_sparse_stacked(
        [v.to(cuda_device) for v in vals], [m.to(cuda_device) for m in masks],
        w, prev_global=[p.to(cuda_device) for p in prev], robust="clip:2.0")
    assert agg_ops.mode_counts() == {"partials": 4, "mean": 0}
    for g, x in zip(got, want):
        torch.testing.assert_close(g.cpu(), x, rtol=3e-5, atol=1e-6)
    kernels.reset_launch_counts()
    aggregation.aggregate_sparse_stacked(
        [v.to(cuda_device) for v in vals], [m.to(cuda_device) for m in masks],
        w, prev_global=[p.to(cuda_device) for p in prev],
        robust="trimmed:0.2")
    assert kernels.launch_counts()["sparse_agg"] == 0


# --- ragged fleets: sparse_agg's elementwise mask, the grouped engine ----

EW_CASES = [(7, (257, 513)), (3, (3, 3)), (5, (1000, 7)),
            (5, (3, 3, 64, 96)), (4, (20, 12, 6))]


def _elementwise_case(gen, dev, n, leaf, dtype):
    """Values, a ragged canvas mask (client i's leading box of the leaf
    under a channel mask, the rest zero) and weights."""
    x = torch.randn((n,) + leaf, generator=gen, device=dev).to(dtype)
    chan = (torch.rand((n,) + (1,) * (len(leaf) - 1) + leaf[-1:],
                       generator=gen, device=dev) > 0.4).to(dtype)
    m = torch.zeros_like(x)
    for i in range(n):
        box = (i,) + tuple(slice(0, max(1, s - i % 3)) for s in leaf)
        m[box] = chan[i].expand(leaf)[box[1:]]
    w = torch.rand((n,), generator=gen, device=dev) + 0.5
    return x, m, w


@pytest.mark.parametrize("n,leaf", EW_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_agg_elementwise_on_card_matches_plain(n, leaf, dtype,
                                                      cuda_device):
    """Both modes with an elementwise mask against the plain version on
    the same tensors (the CPU tests' tolerances; the mean mode bit for bit
    against ``finish_masked_mean`` over the partials mode), one launch
    each, counted under the elementwise routes."""
    from repro_torch.kernels.sparse_agg.ref import (finish_masked_mean,
                                                    masked_weighted_mean_ref)
    gen = torch.Generator(device=cuda_device).manual_seed(len(leaf) + n)
    x, m, w = _elementwise_case(gen, cuda_device, n, leaf, dtype)
    gprev = torch.randn(leaf, generator=gen, device=cuda_device).to(dtype)
    a = int(np.prod(leaf[:-1]))
    c = leaf[-1]
    kernels.reset_launch_counts()
    num, den = agg_ops.masked_weighted_sum(x, m, w)
    got = agg_ops.masked_weighted_mean(x, m, w, gprev, dtype)
    torch.cuda.synchronize()
    assert agg_ops.route_counts() == {
        "partials": 0, "mean": 0, "partials:elementwise": 1,
        "mean:elementwise": 1}
    wnum, wden = masked_weighted_sum_ref(x.view(n, a, c, 1),
                                         m.view(n, a, c, 1), w)
    rtol = 5e-3 if dtype == torch.bfloat16 else 3e-5
    torch.testing.assert_close(num, wnum.view(leaf), rtol=rtol, atol=1e-4)
    torch.testing.assert_close(den, wden.view(leaf), rtol=3e-5, atol=1e-5)
    want = masked_weighted_mean_ref(x.view(n, a, c, 1), m.view(n, a, c, 1),
                                    w, gprev.view(a, c, 1), dtype)
    torch.testing.assert_close(got.float(), want.view(leaf).float(),
                               rtol=2.0 ** -7 if dtype == torch.bfloat16
                               else 3e-5, atol=1e-4)
    assert torch.equal(got, finish_masked_mean(num, den, gprev, dtype))


def test_sparse_agg_elementwise_past_2_31_elements(cuda_device):
    """A bf16 client leaf of (32769, 65536) = 2,147,549,184 elements, two
    clients, an elementwise mask: the kernel indexes in 64 bits, so one
    launch of each mode covers it (no split), equal to the plain version
    in chunks of 2048 rows (the mean mode bit for bit against
    ``finish_masked_mean`` over the partials)."""
    from repro_torch.kernels.sparse_agg.ref import finish_masked_mean
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    n, leaf = 2, (32769, 65536)
    x = torch.randn((n,) + leaf, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    m = (torch.rand((n,) + leaf, generator=gen, device=cuda_device)
         > 0.5).to(torch.bfloat16)
    w = torch.tensor([1.5, 0.75], device=cuda_device)
    kernels.reset_launch_counts()
    got = agg_ops.masked_weighted_mean(x, m, w, None, torch.bfloat16)
    torch.cuda.synchronize()
    assert agg_ops.route_counts()["mean:elementwise"] == 1
    rows = 2048
    for r0 in range(0, leaf[0], rows):
        xs, ms = x[:, r0:r0 + rows], m[:, r0:r0 + rows]
        r = xs.shape[1]
        num, den = masked_weighted_sum_ref(xs.reshape(n, r, leaf[1], 1),
                                           ms.reshape(n, r, leaf[1], 1), w)
        assert torch.equal(got[r0:r0 + r], finish_masked_mean(
            num.view(r, leaf[1]), den.view(r, leaf[1]), None,
            torch.bfloat16)), f"rows {r0}.."
    del got
    num, den = agg_ops.masked_weighted_sum(x, m, w)
    torch.cuda.synchronize()
    for r0 in range(0, leaf[0], 4 * rows):
        xs, ms = x[:, r0:r0 + 4 * rows], m[:, r0:r0 + 4 * rows]
        r = xs.shape[1]
        wnum, wden = masked_weighted_sum_ref(xs.reshape(n, r, leaf[1], 1),
                                             ms.reshape(n, r, leaf[1], 1), w)
        assert torch.equal(num[r0:r0 + r], wnum.view(r, leaf[1]))
        assert torch.equal(den[r0:r0 + r], wden.view(r, leaf[1]))


def _ragged_groups(dev, seed=0, n=6, widths=(12, 8, 6)):
    """A ragged MLP fleet (widths cycling) as grouped stacks on ``dev``:
    (global, [(indices, stacked values, stacked channel masks)])."""
    from repro_torch.fl.heterogeneity import group_by_shape
    gen = torch.Generator().manual_seed(seed)

    def mlp(w):
        return {"fc0": {"w": torch.randn(20, w, generator=gen),
                        "b": torch.randn(w, generator=gen)},
                "fc1": {"w": torch.randn(w, 5, generator=gen),
                        "b": torch.randn(5, generator=gen)}}

    gp = mlp(max(widths))
    clients = [mlp(widths[i % len(widths)]) for i in range(n)]
    out = []
    for g in group_by_shape(clients):
        vals = tree.tree_map(lambda *ls: torch.stack(ls),
                             *[clients[i] for i in g.indices])
        masks = tree.tree_map(
            lambda l: (torch.rand((l.shape[0],) + (1,) * (l.ndim - 2)
                                  + l.shape[-1:], generator=gen)
                       > 0.4).float(), vals)
        out.append((np.asarray(g.indices), vals, masks))
    return gp, out


@pytest.mark.parametrize("robust", ["mean", "clip:1.5"])
def test_aggregate_sparse_grouped_on_card_matches_cpu(robust, cuda_device):
    """The grouped Eq. (4) canvas on the card against the same call on
    the CPU (plain versions): within 3e-5; the mean launches sparse_agg
    once a leaf, elementwise for the rank-2 leaves; clip its partials."""
    from repro_torch.core import aggregation
    gp, groups = _ragged_groups("cpu")
    weights = np.asarray([1.0, 2.0, 0.0, 3.0, 1.5, 2.5])

    def run(dev):
        return aggregation.aggregate_sparse_grouped(
            [tree.tree_map(lambda l: l.to(dev), v) for _, v, _ in groups],
            [tree.tree_map(lambda l: l.to(dev), m) for _, _, m in groups],
            [torch.as_tensor(i, device=dev) for i, _, _ in groups], weights,
            tree.tree_map(lambda l: l.to(dev), gp),
            prev_global=tree.tree_map(lambda l: l.to(dev), gp),
            robust=robust)

    want = run("cpu")
    kernels.reset_launch_counts()
    got = run(cuda_device)
    torch.cuda.synchronize()
    routes = agg_ops.route_counts()
    if robust == "mean":
        assert routes == {"partials": 0, "mean": 2, "partials:elementwise": 0,
                          "mean:elementwise": 2}
    else:
        assert routes["partials"] + routes["partials:elementwise"] == 4
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        torch.testing.assert_close(g.cpu(), w, rtol=3e-5, atol=1e-6)


def test_eq5_at_local_widths_from_a_sliced_global(cuda_device):
    """Eq. (5) of a narrow group against the global sliced to its widths:
    the merge kernel refuses the strided slice itself; ``slice_pytree``
    hands it a contiguous copy, and the merge equals the select on the
    CPU exactly."""
    from repro_torch.core import aggregation, round_engine
    gen = torch.Generator().manual_seed(2)
    glob = {"w": torch.randn(3, 3, 32, 64, generator=gen),
            "b": torch.randn(64, generator=gen)}
    loc = {"w": torch.randn(4, 3, 3, 16, 40, generator=gen),
           "b": torch.randn(4, 40, generator=gen)}
    masks = {"w": (torch.rand(4, 1, 1, 1, 40, generator=gen) > 0.5).float(),
             "b": (torch.rand(4, 40, generator=gen) > 0.5).float()}
    g_dev = tree.tree_map(lambda l: l.to(cuda_device), glob)
    l_dev = tree.tree_map(lambda l: l.to(cuda_device), loc)
    m_dev = tree.tree_map(lambda l: l.to(cuda_device), masks)
    with pytest.raises(ValueError, match="contiguous"):
        mm_ops.masked_merge(g_dev["w"][:, :, :16, :40], l_dev["w"],
                            m_dev["w"])
    template = tree.tree_map(lambda l: l[0], l_dev)
    g_local = round_engine.slice_pytree(g_dev, template)
    assert all(l.is_contiguous() for l in tree.leaves(g_local))
    kernels.reset_launch_counts()
    got = aggregation.client_update_sparse(g_local, l_dev, m_dev)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["masked_merge"] == 1
    for key in ("w", "b"):
        gs = glob[key][tuple(slice(0, s) for s in loc[key].shape[1:])]
        want = torch.where(masks[key] > 0, gs[None], loc[key])
        assert torch.equal(got[key].cpu(), want)


def _ragged_fleet_run(dev, batched, rounds=3):
    from repro_torch.core import protocol
    from repro_torch.core.allocation import ClientTelemetry
    gp, groups = _ragged_groups("cpu", seed=4)
    clients = [None] * 6
    for idx, vals, _ in groups:
        for pos, i in enumerate(idx):
            clients[i] = tree.tree_map(lambda l: l[pos].clone(), vals)
    rng = np.random.default_rng(0)
    tel = ClientTelemetry(
        model_bytes=np.asarray([4.0 * sum(l.numel() for l in tree.leaves(c))
                                for c in clients]),
        uplink_rate=rng.uniform(1e3, 5e3, 6),
        downlink_rate=rng.uniform(5e3, 2e4, 6),
        compute_latency=rng.uniform(1.0, 5.0, 6),
        num_samples=rng.integers(10, 50, 6).astype(float),
        label_coverage=np.ones(6), train_loss=np.ones(6))

    def ltf(p, idx, key):
        g = torch.Generator().manual_seed(int(np.asarray(key)[1]))
        return (tree.tree_map(lambda l: l * 0.99 + 0.01 * torch.randn(
            l.shape, generator=g).to(l.device), p), 1.0 / (idx + 1.0))

    srv = protocol.FedDDServer(
        gp, protocol.ProtocolConfig(rounds=rounds, h=2, batched=batched),
        tel, client_params=clients, device=dev)
    return srv, srv.run(ltf)


def test_grouped_run_equals_loop_on_card(cuda_device):
    """A ragged fleet (3 groups of 2) for 3 rounds on the card: the
    grouped engine and the per-client loop give the same global and
    client params bit for bit and the same records; the grouped run
    launches importance 4 times a group and round, all with coverage,
    sparse_agg once a leaf and round (the two rank-2 leaves elementwise)
    and masked_merge once a group and partial round."""
    kernels.reset_launch_counts()
    grp, rg = _ragged_fleet_run(cuda_device, True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert grp.executor_kind == "grouped"
    assert counts == dict(importance=36, sparse_agg=12, masked_merge=6,
                          flash_attention=0, conv=0)
    assert imp_ops.route_counts() == {"plain": 0, "coverage": 36}
    assert agg_ops.route_counts()["mean:elementwise"] == 6
    loop, rl = _ragged_fleet_run(cuda_device, False)
    for a, b in zip(tree.leaves(rg.global_params),
                    tree.leaves(rl.global_params)):
        assert torch.equal(a, b)
    for ca, cb in zip(grp.clients, loop.clients):
        for a, b in zip(tree.leaves(ca.params), tree.leaves(cb.params)):
            assert torch.equal(a, b)
    for a, b in zip(rg.history, rl.history):
        assert (a.sim_time, a.uploaded_bytes, a.mean_loss) == (
            b.sim_time, b.uploaded_bytes, b.mean_loss)
        np.testing.assert_array_equal(a.dropout_rates, b.dropout_rates)


def test_grouped_step_makes_no_synchronising_call(cuda_device):
    """``GroupedRoundEngine.step`` with staged inputs (device rows,
    rates and weights) makes no synchronising CUDA call, after an
    uncounted warm-up step."""
    from repro_torch import prng
    from repro_torch.core import coverage, round_engine
    gp, groups = _ragged_groups("cpu", seed=6)
    gp = tree.tree_map(lambda l: l.to(cuda_device), gp)
    widths = coverage.coverage_rates(
        [coverage.channel_widths(tree.tree_map(lambda l: l[0], v))
         for _, v, _ in groups], coverage.channel_widths(gp))
    batches = []
    for idx, vals, _ in groups:
        old = tree.tree_map(lambda l: l.to(cuda_device), vals)
        new = tree.tree_map(lambda l: l * 1.01 + 0.01, old)
        batches.append(round_engine.GroupBatch(
            idx, old, new,
            coverage.coverage_pytree(tree.tree_map(lambda l: l[0], old),
                                     widths),
            torch.linspace(0.1, 0.5, len(idx), device=cuda_device),
            torch.as_tensor(idx, device=cuda_device)))
    weights = torch.arange(1.0, 7.0, device=cuda_device)
    engine = round_engine.GroupedRoundEngine()
    counted = [{}, {}]
    for c in counted:
        torch.cuda.synchronize()
        with _smoke()._count_syncs(c, cuda_device):
            out = engine.step(batches, gp, weights, prng.PRNGKey(1),
                              full_round=False)
    assert counted[1] == {"syncs": 0, "where": {}}
    assert torch.isfinite(out.densities).all()


# --- the simulator, the fault layer and crash-resume on the card -----------

def _sim_fixture(dev, n=6, width=12, seed=0):
    gen = np.random.default_rng(seed)
    params = {"fc0": {"w": torch.from_numpy(gen.normal(size=(20, width))
                                            .astype(np.float32)).to(dev),
                      "b": torch.zeros(width, device=dev)},
              "fc1": {"w": torch.from_numpy(gen.normal(size=(width, 5))
                                            .astype(np.float32)).to(dev),
                      "b": torch.zeros(5, device=dev)}}
    from repro_torch.core.allocation import ClientTelemetry
    nbytes = float(sum(l.numel() * 4 for l in tree.leaves(params)))
    tel = ClientTelemetry(
        model_bytes=np.full(n, nbytes), uplink_rate=gen.uniform(1e3, 5e3, n),
        downlink_rate=gen.uniform(5e3, 2e4, n),
        compute_latency=gen.uniform(1.0, 5.0, n),
        num_samples=gen.integers(10, 50, n).astype(float),
        label_coverage=gen.uniform(0.5, 1.0, n), train_loss=np.ones(n))

    def ltf(p, i, key):
        rng = np.random.default_rng(np.asarray(key).tolist())
        leaves, td = tree.flatten(p)
        return tree.unflatten(td, [
            l * 0.99 + torch.from_numpy(rng.normal(0, 0.01, tuple(l.shape))
                                        .astype(np.float32)).to(l.device)
            for l in leaves]), 1.0 / (i + 1.0)

    return params, tel, ltf


def test_sim_sync_static_equals_protocol_on_card(cuda_device):
    """Sync over a static network equals the protocol driver bit for bit
    on the card (Eq. (12) clock and global params), and every FedDD round
    launches the three kernels."""
    from repro_torch import sim
    from repro_torch.core import protocol
    params, tel, ltf = _sim_fixture(cuda_device)
    kw = dict(rounds=4, a_server=0.6, h=3, seed=0, device=cuda_device)
    ref = protocol.run_scheme("feddd", params, tel, ltf, None, **kw)
    kernels.reset_launch_counts()
    got = sim.run_sim("feddd", params, tel, ltf, None,
                      sim=sim.SimConfig(policy="sync"), **kw)
    counts = kernels.launch_counts()
    assert counts["importance"] == counts["sparse_agg"] == 4 * 4
    assert counts["masked_merge"] == 3
    assert [r.sim_time for r in ref.history] == \
        [r.sim_time for r in got.history]
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(ref.global_params), tree.leaves(got.global_params)))


@pytest.mark.parametrize("case", ["prefix", "nonfinite"])
def test_sparse_agg_on_sim_inputs_matches_plain(case, cuda_device):
    """The mean mode on the simulator's new inputs at fc0 of 16 clients:
    channel masks cut to delivered prefixes, and uploads with NaN / Inf /
    an all-ones exponent at kept and dropped channels (one such row at
    weight 0), against the plain version with ``equal_nan``."""
    from repro_torch.core import aggregation
    from repro_torch.kernels.sparse_agg.ref import masked_weighted_mean_ref
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    n, a, c = 16, 784, 100
    vals = torch.randn((n, a, c), generator=gen, device=cuda_device)
    gprev = torch.randn((a, c), generator=gen, device=cuda_device)
    w = torch.rand((n,), generator=gen, device=cuda_device) + 0.5
    keep = (torch.rand((n, 1, c), generator=gen, device=cuda_device)
            > 0.4).float()
    if case == "prefix":
        cut = torch.full((n,), np.iinfo(np.int32).max, dtype=torch.int32,
                         device=cuda_device)
        cut[:8] = torch.arange(8, device=cuda_device, dtype=torch.int32) * 5
        mask = aggregation.truncate_masks_to_prefix([keep], [cut])[0]
        assert int(mask.sum()) < int(keep.sum())
    else:
        mask = keep
        for row, val in ((3, float("nan")), (5, float("inf")),
                         (7, float("-inf"))):
            vals[row, 1, int(torch.nonzero(keep[row, 0])[0])] = val
            vals[row, 2, int(torch.nonzero(keep[row, 0] == 0)[0])] = val
        vals[9].view(torch.int32)[0, int(torch.nonzero(keep[9, 0])[0])] |= \
            0x7F800000
        w[3] = 0.0
    before = kernels.launch_counts()["sparse_agg"]
    got = agg_ops.masked_weighted_mean(vals, mask, w, gprev, torch.float32)
    assert kernels.launch_counts()["sparse_agg"] == before + 1
    want = masked_weighted_mean_ref(vals.view(n, a, c, 1), mask.view(n, c),
                                    w, gprev.view(a, c, 1),
                                    torch.float32).view(a, c)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=1e-4,
                               equal_nan=True)
    if case == "nonfinite":
        assert bool((~torch.isfinite(got)).any())


def test_sim_resume_digest_on_card(cuda_device, tmp_path):
    """A faulty sync run checkpointed every round and resumed from its
    round-2 snapshot equals the uninterrupted run on the card: event
    trace, records and global params bit for bit."""
    from repro_torch import sim
    params, tel, ltf = _sim_fixture(cuda_device, n=5)
    path = str(tmp_path / "ck.npz")
    kw = dict(sim=sim.SimConfig(policy="sync"),
              faults=sim.CellOutageModel(
                  5, sim.OutageConfig(cells=2, p_out=0.3, seed=3),
                  inner=sim.RandomFaults(crash_rate=0.15, loss_rate=0.1,
                                         seed=5)),
              a_server=0.6, h=2, seed=0, device=cuda_device)
    full = sim.run_sim("feddd", params, tel, ltf, None, rounds=5, **kw)
    sim.run_sim("feddd", params, tel, ltf, None, rounds=2,
                checkpoint_every=1, checkpoint_path=path, **kw)
    resumed = sim.run_sim("feddd", params, tel, ltf, None, rounds=5,
                          checkpoint_every=1, checkpoint_path=path,
                          resume_from=path, **kw)
    assert full.event_trace == resumed.event_trace
    assert [r.sim_time for r in full.history] == \
        [r.sim_time for r in resumed.history]
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(full.global_params), tree.leaves(resumed.global_params)))


# --- the client-sharded mesh and C5's select flag on the card ---------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_agg_select_matches_plain_on_card(dtype, cuda_device):
    """Both modes with ``select`` against the plain version on a poisoned
    input (NaN / Inf at a kept and at a dropped channel, one row at weight
    0): equal, NaNs at the same places; the flag drops the dropped-channel
    values only; on finite values it changes no bit; each launch with it
    counts once under ``select_counts``."""
    from repro_torch.kernels.sparse_agg.ref import masked_weighted_mean_ref
    n, r, c = 16, 784, 100
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    vals = torch.randn((n, r, c), generator=gen, device=cuda_device)
    keep = (torch.rand((n, 1, c), generator=gen, device=cuda_device)
            > 0.4).float()
    w = torch.rand((n,), generator=gen, device=cuda_device) + 0.5
    gprev = torch.randn((r, c), generator=gen, device=cuda_device)
    bad = vals.clone()
    for row, val in ((3, float("nan")), (5, float("inf"))):
        bad[row, 1, int(torch.nonzero(keep[row, 0])[0])] = val
        bad[row, 2, int(torch.nonzero(keep[row, 0] == 0)[0])] = val
    w[3] = 0.0
    vals, bad, keep = vals.to(dtype), bad.to(dtype), keep.to(dtype)
    rtol = 5e-3 if dtype == torch.bfloat16 else 3e-5
    kernels.reset_launch_counts()
    nonfinite = {}
    for sel in (False, True):
        num, den = agg_ops.masked_weighted_sum(bad, keep, w, select=sel)
        wnum, wden = masked_weighted_sum_ref(bad.view(n, r, c, 1),
                                             keep.view(n, c), w, sel)
        torch.testing.assert_close(num, wnum.view(r, c), rtol=rtol,
                                   atol=1e-4, equal_nan=True)
        torch.testing.assert_close(den, wden.view(r, c), rtol=3e-5,
                                   atol=1e-5)
        got = agg_ops.masked_weighted_mean(bad, keep, w, gprev,
                                           torch.float32, select=sel)
        want = masked_weighted_mean_ref(bad.view(n, r, c, 1),
                                        keep.view(n, c), w,
                                        gprev.view(r, c, 1), torch.float32,
                                        sel).view(r, c)
        torch.testing.assert_close(got, want, rtol=rtol, atol=1e-4,
                                   equal_nan=True)
        nonfinite[sel] = int((~torch.isfinite(got)).sum())
    assert 0 < nonfinite[True] < nonfinite[False]
    for sel in (False, True):
        assert torch.equal(
            agg_ops.masked_weighted_mean(vals, keep, w, gprev,
                                         torch.float32, select=sel),
            agg_ops.masked_weighted_mean(vals, keep, w, gprev,
                                         torch.float32))
    torch.cuda.synchronize()
    assert agg_ops.select_counts() == {"select": 3}


def _shard_case(dev, n, seed=0):
    """The paper's MLP as n clients' stacks on ``dev``: the global, the
    old and new stacks (seeded numpy noise) and the weights."""
    from repro_torch import prng
    from repro_torch.fl import MLP_SPEC, init_cnn_spec
    g = init_cnn_spec(MLP_SPEC, prng.PRNGKey(seed), device=dev)
    rng = np.random.default_rng(seed)

    def noisy(t, scale):
        return tree.tree_map(lambda l: l + torch.from_numpy(
            rng.normal(0, scale, tuple(l.shape)).astype(np.float32)).to(dev),
            t)
    old = noisy(tree.tree_map(lambda l: torch.stack([l] * n), g), 0.01)
    new = noisy(old, 0.01)
    w = torch.arange(1.0, n + 1.0, device=dev)
    return g, old, new, w


@pytest.mark.parametrize("full_round,dense", [(False, False), (True, False),
                                              (False, True)])
def test_one_shard_bit_equal_to_engine_on_card(full_round, dense,
                                               cuda_device):
    """One shard on the card: the partials mode and ``finish_masked_mean``
    give the engine's mean mode bit for bit (global, clients, densities)."""
    from repro_torch import prng
    from repro_torch.core import round_engine
    from repro_torch.launch.mesh import ClientMesh
    g, old, new, w = _shard_case(cuda_device, 10)
    d = torch.linspace(0.0, 0.6, 10, device=cuda_device)
    rk = prng.PRNGKey(3)
    a = round_engine.BatchedRoundEngine().step(
        old, new, g, d, w, rk, full_round=full_round, dense_masks=dense)
    b = round_engine.ShardedRoundEngine(mesh=ClientMesh((cuda_device,))).step(
        old, new, g, d, w, rk, full_round=full_round, dense_masks=dense)
    for x, y in zip(tree.leaves(a.global_params) + tree.leaves(
            a.client_params) + [a.densities],
            tree.leaves(b.global_params) + tree.leaves(b.client_params)
            + [b.densities]):
        assert torch.equal(x, y)


def test_virtual_shards_on_card_launch_per_shard_and_match(cuda_device):
    """13 clients over 4 virtual shards of the card (pad 3): importance
    and sparse_agg's partials mode once a shard and leaf, masked_merge
    once a shard, the select flag at the 1-D leaves; within 2e-6 of the
    engine with equal densities, dense and keep-0.8 sparse at D = 0.75
    (overflow 0), and of the same step on the CPU."""
    from repro_torch import prng
    from repro_torch.core import round_engine
    from repro_torch.kernels.masked_merge import ops as merge_ops
    from repro_torch.launch.mesh import ClientMesh
    n, p = 13, 4
    g, old, new, w = _shard_case(cuda_device, n, seed=1)
    rk = prng.PRNGKey(3)
    mesh = ClientMesh((cuda_device,) * p)
    base = round_engine.BatchedRoundEngine()
    for coll, keep, d in (("dense", 1.0, torch.linspace(0.0, 0.6, n)),
                          ("sparse", 0.8, torch.full((n,), 0.75))):
        d = d.to(cuda_device)
        eng = round_engine.ShardedRoundEngine(mesh=mesh, collective=coll,
                                              keep_fraction=keep)
        kernels.reset_launch_counts()
        got = eng.step(old, new, g, d, w, rk, full_round=False)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == dict(
            importance=6 * p, sparse_agg=6 * p, masked_merge=p,
            flash_attention=0, conv=0)
        assert agg_ops.mode_counts() == {"partials": 6 * p, "mean": 0}
        assert agg_ops.select_counts() == {"select": 3 * p}
        assert merge_ops.leaf_counts() == {6: p}
        assert float(got.collective_overflow) == 0.0
        want = base.step(old, new, g, d, w, rk, full_round=False)
        assert torch.equal(got.densities, want.densities)
        for x, y in zip(tree.leaves(got.global_params) +
                        tree.leaves(got.client_params),
                        tree.leaves(want.global_params) +
                        tree.leaves(want.client_params)):
            torch.testing.assert_close(x, y, rtol=2e-6, atol=2e-6)
        cpu = [tree.tree_map(lambda l: l.cpu(), t) for t in (old, new, g)]
        on_cpu = round_engine.ShardedRoundEngine(
            mesh=ClientMesh(("cpu",) * p), collective=coll,
            keep_fraction=keep).step(*cpu, d.cpu(), w.cpu(), rk,
                                     full_round=False)
        assert torch.equal(on_cpu.densities, got.densities.cpu())
        for x, y in zip(tree.leaves(got.global_params),
                        tree.leaves(on_cpu.global_params)):
            torch.testing.assert_close(x.cpu(), y, rtol=2e-6, atol=2e-6)


def test_virtual_mesh_step_copies_nothing_and_never_syncs(cuda_device):
    """A sharded step over virtual shards with staged inputs makes no
    ``.to()`` copy between devices and no synchronising CUDA call (after
    an uncounted warm-up step)."""
    from repro_torch import prng
    from repro_torch.core import round_engine
    from repro_torch.launch.mesh import ClientMesh
    smoke = _smoke()
    g, old, new, w = _shard_case(cuda_device, 10)
    d = torch.full((10,), 0.5, device=cuda_device)
    eng = round_engine.ShardedRoundEngine(
        mesh=ClientMesh((cuda_device,) * 4), collective="sparse",
        keep_fraction=0.8)
    counted, moves = [{}, {}], {}
    for c in counted:
        torch.cuda.synchronize()
        with smoke._count_syncs(c, cuda_device), smoke._count_moves(moves):
            out = eng.step(old, new, g, d, w, prng.PRNGKey(1),
                           full_round=False)
    assert counted[1] == {"syncs": 0, "where": {}}
    assert moves["moves"] == 0
    assert torch.isfinite(out.densities).all()


def test_sharded_step_across_two_cards(cuda_device):
    """Shards on cuda:0 and cuda:1 (rows moved by non-blocking copies):
    within 2e-6 of the engine with equal densities.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (virtual shards of one card run "
                    "the multi-shard step above)")
    from repro_torch import prng
    from repro_torch.core import round_engine
    from repro_torch.launch.mesh import make_client_mesh
    g, old, new, w = _shard_case(cuda_device, 13)
    d = torch.linspace(0.0, 0.6, 13, device=cuda_device)
    mesh = make_client_mesh(2, device=cuda_device)
    assert mesh.devices == (torch.device("cuda", 0),
                            torch.device("cuda", 1))
    got = round_engine.ShardedRoundEngine(mesh=mesh).step(
        old, new, g, d, w, prng.PRNGKey(3), full_round=False)
    want = round_engine.BatchedRoundEngine().step(
        old, new, g, d, w, prng.PRNGKey(3), full_round=False)
    assert torch.equal(got.densities, want.densities)
    for x, y in zip(tree.leaves(got.global_params),
                    tree.leaves(want.global_params)):
        torch.testing.assert_close(x, y, rtol=2e-6, atol=2e-6)


# --- LM training, FedDD across pods and the MoE family -----------------------

def _lm_cfg(arch, dtype="float32", **over):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, reduced=True),
                               param_dtype=dtype, compute_dtype=dtype, **over)


def _to_cpu(t):
    return tree.tree_map(lambda x: x.cpu(), t)


@pytest.mark.parametrize("arch,mb", [("granite_3_8b", 1),
                                     ("qwen3_moe_30b_a3b", 2)])
def test_train_step_on_card_matches_cpu(arch, mb, cuda_device):
    """Two adafactor steps on the card against the CPU (plain matmuls,
    fp32, TF32 off): loss and params within 1e-4; no kernel launches."""
    from repro_torch.models import lm
    from repro_torch.optim import adafactor
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg(arch)
    opt = adafactor(1e-2)
    state = lm.init_train_state(cfg, opt, torch.Generator(
        device=cuda_device).manual_seed(0), cuda_device)
    cpu = lm.TrainState(_to_cpu(state.params), _to_cpu(state.opt_state),
                        state.step.cpu())
    step = lm.make_train_step(cfg, opt, mb)
    toks = torch.randint(0, cfg.vocab_size, (2, 4, 32),
                         generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    for t in toks:
        state, m = step(state, {"tokens": t.to(cuda_device)})
        cpu, mc = step(cpu, {"tokens": t})
        assert abs(float(m["loss"]) - float(mc["loss"])) <= 1e-4
    assert not any(kernels.launch_counts().values())
    for a, b in zip(tree.leaves(state.params), tree.leaves(cpu.params)):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_chunked_route_trains_on_card_and_flash_refuses_grad(cuda_device,
                                                              monkeypatch):
    """At S >= FLASH_MIN_SEQ a step with grad takes the chunked route (no
    flash launch) and gives q, k and v gradients equal to the plain
    attention's; the flash wrapper raises on inputs that require grad."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 64)
    monkeypatch.setattr(attention, "FLASH_CHUNK", 32)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(1, 100, h, 64, generator=gen, device=cuda_device,
                           requires_grad=True) for h in (4, 2, 2))
    kernels.reset_launch_counts()
    out = attention._sdpa_chunked(q, k, v, mode="full", window=0)
    out.square().sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    want = attention._sdpa(q, k, v, attention.causal_mask(
        100, 100, device=cuda_device)[None])
    want.square().sum().backward()
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
    for g, t in zip(grads, (q, k, v)):
        torch.testing.assert_close(g, t.grad, rtol=1e-4, atol=1e-4)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert kernels.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("leaf", [(2, 256, 4, 128), (515, 256),
                                  (2, 256, 512)])
def test_importance_at_lm_leaves_matches_plain(leaf, cuda_device):
    """bf16 LM leaves read around their last-axis channels (one pod, N=1):
    the kernel against its plain version at rtol 5e-5, atol 1e-5."""
    from repro_torch.kernels import _lib
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    wo = (torch.randn((1, *leaf), generator=gen, device=cuda_device)
          * 0.02).to(torch.bfloat16)
    wn = (wo.float() + 1e-3 * torch.randn((1, *leaf), generator=gen,
                                          device=cuda_device)
          ).to(torch.bfloat16)
    a, c, b = _lib.split_at(leaf, len(leaf) - 1)
    got = imp_ops.channel_importance_batched(wo, wn)
    want = channel_importance_ref(wo.view(1, a, c, b), wn.view(1, a, c, b))
    torch.testing.assert_close(got, want, rtol=5e-5, atol=1e-5)


def test_federated_round_on_card_matches_cpu(cuda_device, monkeypatch):
    """Two virtual pods of the card against two CPU pods: one importance
    launch per rank-2+ leaf and pod, params within 1e-4, equal kept
    channel sets."""
    from repro_torch.core import sparse_collective
    from repro_torch.launch import federated
    from repro_torch.models import lm
    real_topk = sparse_collective.compact_topk
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg("granite_3_8b", num_layers=2)
    params = lm.init_model(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 16),
                         generator=torch.Generator().manual_seed(2))
    d = np.array([0.3, 0.6], np.float32)
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        mesh = federated.pod_mesh(2, dev)
        pods = [tree.tree_map(lambda t: t.to(dev, copy=True), params)
                for _ in range(2)]
        kept = []       # what compact_topk picks in sparse_allgather_mean

        def recording(values, scores, k):
            compact, idx = real_topk(values, scores, k)
            kept.append(idx.cpu())
            return compact, idx

        monkeypatch.setattr(sparse_collective, "compact_topk", recording)
        kernels.reset_launch_counts()
        out, losses = federated.make_round_fn(cfg, mesh, 3e-2, 2, 0.75)(
            pods, [t.to(dev) for t in toks], d)
        runs[dev.type] = (out, losses, kept, kernels.launch_counts())
    out, losses, kept, counts = runs["cuda"]
    ranked = sum(t.ndim >= 2 for t in tree.leaves(params))
    assert counts["importance"] == 2 * ranked
    assert runs["cpu"][3]["importance"] == 0
    torch.testing.assert_close(losses.cpu(), runs["cpu"][1], rtol=1e-4,
                               atol=1e-4)
    for p_gpu, p_cpu in zip(out, runs["cpu"][0]):
        for a, b in zip(tree.leaves(p_gpu), tree.leaves(p_cpu)):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    assert len(kept) == len(runs["cpu"][2]) == 2 * ranked
    for kg, kc, kl in zip(kept, runs["cpu"][2], [
            min(n, k) for t in tree.leaves(params) if t.ndim >= 2
            for k in [int(np.ceil(t.shape[-1] * 0.75))]
            for n in federated.keep_counts(t.shape[-1], d)]):
        assert sorted(kg[:kl].tolist()) == sorted(kc[:kl].tolist())


def test_moe_forward_and_decode_on_card(cuda_device, monkeypatch):
    """The reduced qwen3-moe on the card: forward within 1e-4 of the CPU
    (fp32), decode equal to forward, two runs bit-equal.  Decode equals
    forward only where the forward drops no assignment, so the experts
    get capacity for every token (capacity factor E / k) and the test
    asserts that nothing was dropped."""
    import dataclasses
    from repro_torch.models import lm, moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg("qwen3_moe_30b_a3b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    kept = []
    real = moe._positions_in_expert

    def spy(flat_ids, e, cap):
        pos, keep = real(flat_ids, e, cap)
        kept.append(bool(keep.all()))
        return pos, keep

    monkeypatch.setattr(moe, "_positions_in_expert", spy)
    params = lm.init_model(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(4))
    full, aux = lm.forward(params, cfg, {"tokens": toks.to(cuda_device)})
    again, _ = lm.forward(params, cfg, {"tokens": toks.to(cuda_device)})
    assert torch.equal(full, again)
    want, waux = lm.forward(_to_cpu(params), cfg, {"tokens": toks})
    scale = float(want.abs().max())
    assert float((full.cpu() - want).abs().max()) <= 1e-4 * scale
    assert abs(float(aux) - float(waux)) <= 1e-5
    state = lm.init_decode_state(params, cfg, 2, 16)
    step = lm.make_serve_step(cfg)
    outs = []
    for t in range(16):
        lg, state = step(params, state, toks[:, t:t + 1].to(cuda_device))
        outs.append(lg)
    dec = torch.stack(outs, 1)
    assert kept and all(kept)
    assert float((dec - full).abs().max()) <= 1e-4 * float(full.abs().max())


# --- the recurrent, VLM and enc-dec families --------------------------------

@pytest.mark.parametrize("arch", ["jamba_1p5_large_398b", "xlstm_1p3b",
                                  "pixtral_12b", "whisper_medium"])
def test_family_prefill_and_decode_on_card(arch, cuda_device, monkeypatch):
    """A reduced model of each family on the card (fp32, TF32 off): with
    the flash threshold below the prompt every causal attention layer
    launches the kernel (none in xLSTM, none in whisper's bidirectional
    encoder), the prefill (pixtral with patches, whisper with frames)
    matches the same model on the CPU within 1e-4, decode over the prompt
    reproduces the forward logits within 1e-4, and the decode states stay
    on the card.  Jamba's experts get room for every token (capacity
    factor E / k), as decode = forward needs."""
    import dataclasses
    from repro_torch.models import attention, lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 32)
    params = lm.init_model(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), cuda_device)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     generator=gen)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (2, cfg.num_patch_tokens, cfg.d_model), generator=gen)
    if cfg.is_encdec:
        batch["enc_frames"] = torch.randn((2, 24, cfg.d_model),
                                          generator=gen)
    on_card = {k: v.to(cuda_device) for k, v in batch.items()}
    kernels.reset_launch_counts()
    got = lm.prefill(params, cfg, on_card)
    torch.cuda.synchronize()
    causal = sum(s.mixer in ("attn", "attn_local") for s in cfg.layout())
    assert kernels.launch_counts()["flash_attention"] == causal
    want = lm.prefill(_to_cpu(params), cfg, batch)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())

    text = {k: v[:, :16] if k == "tokens" else v
            for k, v in on_card.items() if k != "patch_embeds"}
    full, _ = lm.forward(params, cfg, text)
    state = lm.init_decode_state(params, cfg, 2, 16,
                                 enc_frames=text.get("enc_frames"))
    step = lm.make_serve_step(cfg)
    outs = []
    for t in range(16):
        lg, state = step(params, state, text["tokens"][:, t:t + 1])
        outs.append(lg)
    dec = torch.stack(outs, 1)
    assert float((dec - full).abs().max()) <= 1e-4 * float(full.abs().max())
    assert all(f.is_cuda for nt in tree.leaves(state.stack) for f in nt)


@pytest.mark.parametrize("dtype,hd,window", [(torch.bfloat16, 128, 0),
                                             (torch.bfloat16, 64, 48),
                                             (torch.float32, 32, 0)])
def test_flash_meta_branch_cost_equals_the_launch(dtype, hd, window,
                                                  cuda_device):
    """The flash wrapper's meta branch (the dry-run's trace) reports the
    same cost as a launch on the card, on either route, and allocates the
    same output."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.hlo_analysis import CostCounter
    counts = {}
    for dev in (cuda_device, torch.device("meta")):
        q = torch.randn((2, 300, 8, hd), device=dev, dtype=dtype)
        kv = torch.randn((2, 300, 2, hd), device=dev, dtype=dtype)
        before = kernels.launch_counts()["flash_attention"]
        with CostCounter(dev.type) as c:
            out = flash_ops.flash_attention(q, kv, kv, causal=True,
                                            window=window)
        assert out.shape == q.shape and out.dtype == dtype
        launched = kernels.launch_counts()["flash_attention"] - before
        assert launched == (1 if dev.type == "cuda" else 0)
        counts[dev.type] = (c.by_op()["kernel:flash_attention"],
                            c.by_op()["aten.empty.memory_format"],
                            c.totals()["peak_live_bytes"])
    assert counts["cuda"] == counts["meta"]
    assert counts["cuda"][0]["flops"] == flash_ops.cost(
        2, 300, 300, 8, 2, hd, True, window, q.element_size())[0]


def test_perf_federated_on_card_matches_cpu(cuda_device, monkeypatch):
    """The pods' sync of one cell on two virtual pods of the card against
    two CPU pods, every mode: equal bytes per kind, equal kept channel
    sets, shards within 1e-6 (dense: equal), importance launched once per
    rank-2+ leaf and pod in the compacted modes."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import perf_federated as pf
    from repro_torch.launch.federated import pod_mesh
    from repro_torch.launch.mesh import ProductionMesh
    cfg = dataclasses.replace(get_config("granite_3_8b", reduced=True),
                              param_dtype="float32",
                              compute_dtype="float32")
    mesh = ProductionMesh(("pod", "data", "model"), (2, 2, 2))
    cpu_pods = pod_mesh(2, "cpu")
    _, local = pf.build_sync(cfg, mesh, "dense")
    olds, news = pf.random_cell(cfg, local, cpu_pods)
    card_pods = pod_mesh(2, cuda_device)
    card_cell = tuple([tree.tree_map(lambda t: t.to(cuda_device), p)
                       for p in side] for side in (olds, news))
    ranked = sum(len(s) >= 2 for s in tree.leaves(local))
    real_topk = pf.compact_topk
    for mode, d, q in pf.MODES:
        runs = {}
        for pods, cell in ((card_pods, card_cell),
                           (cpu_pods, (olds, news))):
            kept = []

            def recording(values, scores, k):
                compact, idx = real_topk(values, scores, k)
                kept.append(sorted(idx.cpu().tolist()))
                return compact, idx

            monkeypatch.setattr(pf, "compact_topk", recording)
            rec, out = pf.run_one(cfg, mesh, pods, mode, d, q, cell)
            runs[pods.devices[0].type] = (rec, out, kept)
        (rc, oc, kc), (rp, op, kp) = runs["cuda"], runs["cpu"]
        assert rc["collective_per_device"] == rp["collective_per_device"]
        assert rc["importance_launches"] == (2 * ranked if mode == "feddd"
                                             else 0)
        assert rp["importance_launches"] == 0
        assert kc == kp
        for a, b in zip(tree.leaves(oc), tree.leaves(op)):
            if mode == "dense":
                assert torch.equal(a.cpu(), b)
            else:
                torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-6)


def _virtual_card_mesh(cuda_device):
    from repro_torch.launch.mesh import LMMesh
    return LMMesh.virtual(cuda_device, 2, 2)


def test_meshed_prefill_and_serve_on_card_match_unmeshed(cuda_device,
                                                         monkeypatch):
    """A 4-layer reduced gemma3 (fp32) on a virtual (2, 2) mesh of the
    card: flash launched once per layer and device (16) on its head
    group, the meshed prefill and 12 serve steps within 1e-4 of the
    unmeshed run on the card, every cache block on the card with its
    ``local_shape``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import attention, lm, sharding
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma3_27b", reduced=True),
                              num_layers=4, param_dtype="float32",
                              compute_dtype="float32")
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 32)
    params = lm.init_model(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), cuda_device)
    mesh = _virtual_card_mesh(cuda_device)
    placed = lm.place_params(params, cfg, mesh)
    assert sharding.device_bytes(placed) == [sharding.local_bytes(
        params, placed.specs, mesh)] * 4
    toks = torch.randint(0, cfg.vocab_size, (2, 48), device=cuda_device,
                         generator=torch.Generator(device=cuda_device)
                         .manual_seed(1))
    want = lm.prefill(params, cfg, {"tokens": toks})
    kernels.reset_launch_counts()
    got = lm.prefill(placed, cfg, {"tokens": toks}, mesh=mesh)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 4 * mesh.size
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    step, step0 = lm.make_serve_step(cfg, mesh), lm.make_serve_step(cfg)
    st = lm.init_decode_state(placed, cfg, 4, 12, mesh=mesh)
    st0 = lm.init_decode_state(params, cfg, 4, 12)
    seq = torch.randint(0, cfg.vocab_size, (4, 12), device=cuda_device)
    for t in range(12):
        a, st = step(placed, st, seq[:, t:t + 1])
        b, st0 = step0(params, st0, seq[:, t:t + 1])
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for shard in st.stack.shards:
        for t, sp, full in zip(tree.named_values(shard),
                               tree.named_values(st.stack.specs),
                               tree.named_values(st0.stack)):
            assert t.is_cuda and tuple(t.shape) == sharding.local_shape(
                full.shape, sp, mesh)


def test_moe_takes_the_ep_path_on_a_card_mesh(cuda_device):
    """Reduced qwen3-moe (fp32) on a virtual (2, 2) mesh of the card takes
    the expert-parallel path in every layer and matches the unmeshed
    dispatch in 2 blocks; two meshed runs are bit-equal."""
    import dataclasses
    import functools
    from repro_torch.configs import get_config
    from repro_torch.models import lm, moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen3_moe_30b_a3b", reduced=True),
                              param_dtype="float32", compute_dtype="float32")
    params = lm.init_model(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(2), cuda_device)
    mesh = _virtual_card_mesh(cuda_device)
    placed = lm.place_params(params, cfg, mesh)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda_device)
    moe.reset_dispatch_counts()
    got = lm.prefill(placed, cfg, {"tokens": toks}, mesh=mesh)
    assert moe.dispatch_counts() == {"one_block": 0, "blocked": 0,
                                     "ep": cfg.num_layers}
    again = lm.prefill(placed, cfg, {"tokens": toks}, mesh=mesh)
    assert torch.equal(got, again)
    real = moe.apply_moe
    moe.apply_moe = functools.partial(real, n_blocks=2)
    try:
        want = lm.prefill(params, cfg, {"tokens": toks})
    finally:
        moe.apply_moe = real
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _forced_route(routes, mesh, n_layers):
    """A ``moe.route`` that routes each call as the meshed step's forward
    routed that layer (``routes``: every device's ids, layer by layer; a
    block's ids read from model column 0), for an unmeshed step: its
    forward, then its remat recompute in reverse layer order.  The gates
    and the load-balance loss are ``route``'s, from the run's own router
    probabilities at those experts.  Returns (route, the calls left)."""
    cols = [k for k in range(mesh.size) if mesh.col(k) == 0]
    fwd = [torch.cat([routes[layer * mesh.size + k] for k in cols])
           for layer in range(n_layers)]
    order = iter(fwd + fwd[::-1])

    def forced(p, x, mcfg):
        ids = next(order)
        probs = torch.softmax(torch.matmul(x.float(), p["router"]), dim=-1)
        top = torch.gather(probs, 1, ids)
        top = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
        flat = ids.reshape(-1)
        ce = torch.zeros(mcfg.num_experts, device=x.device).index_add(
            0, flat, torch.ones(flat.shape, device=x.device))
        ce = ce / torch.clamp(ce.sum(), min=1.0)
        aux = (probs.mean(dim=0) * ce).sum() * mcfg.num_experts
        return ids, top.to(x.dtype), aux

    return forced, order


@pytest.mark.parametrize("arch", ["gemma3_27b", "qwen3_moe_30b_a3b"])
def test_meshed_train_step_on_card_matches_unmeshed(cuda_device, arch,
                                                    monkeypatch):
    """A reduced fp32 AdamW step on a virtual (2, 2) mesh of the card at
    S >= FLASH_MIN_SEQ (the chunked attention route: flash is never
    launched under grad): loss and grad norm within 2e-5 of the unmeshed
    step, moments within 2e-5 gathered, every replica bit-equal, every
    block on the card with its ``local_shape``; two meshed steps from one
    state are bit-equal.  qwen3-moe takes the expert-parallel path in
    every layer (its forward and the remat recompute) and is held against
    the unmeshed dispatch in 2 blocks routed as the mesh routed: at these
    16384 tokens a layer's router sends ~1 near-tied token elsewhere once
    its input is summed in another order (measured on the card), which
    moves the gradients of that token's path."""
    import dataclasses
    import functools
    from repro_torch.configs import get_config
    from repro_torch.models import attention, lm, moe, sharding
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              param_dtype="float32", compute_dtype="float32")
    params = lm.init_model(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(3), cuda_device)
    mesh = _virtual_card_mesh(cuda_device)
    opt = adamw(1e-3)
    toks = torch.randint(0, cfg.vocab_size, (2, attention.FLASH_MIN_SEQ),
                         device=cuda_device,
                         generator=torch.Generator(device=cuda_device)
                         .manual_seed(4))

    def fresh():
        p = tree.tree_map(torch.clone, params)
        return lm.TrainState(p, opt.init(p), torch.zeros(
            (), dtype=torch.int32, device=cuda_device))

    routes, real_route = [], moe.route

    def recording(p, x, mcfg):
        out = real_route(p, x, mcfg)
        routes.append(out[0])
        return out

    kernels.reset_launch_counts()
    moe.reset_dispatch_counts()
    monkeypatch.setattr(moe, "route", recording)
    got, gm = lm.make_train_step(cfg, opt, mesh=mesh)(
        lm.place_train_state(fresh(), cfg, mesh), {"tokens": toks})
    monkeypatch.setattr(moe, "route", real_route)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 0
    if cfg.moe is not None:
        assert moe.dispatch_counts() == {"one_block": 0, "blocked": 0,
                                         "ep": 2 * cfg.num_layers}
    again, am = lm.make_train_step(cfg, opt, mesh=mesh)(
        lm.place_train_state(fresh(), cfg, mesh), {"tokens": toks})
    assert float(am["loss"]) == float(gm["loss"])
    for a, b in zip(tree.leaves(sharding.gather(got.params)),
                    tree.leaves(sharding.gather(again.params))):
        assert torch.equal(a, b)
    monkeypatch.setattr(moe, "apply_moe",
                        functools.partial(moe.apply_moe, n_blocks=2))
    left = iter(())
    if cfg.moe is not None:
        forced, left = _forced_route(routes, mesh, cfg.num_layers)
        monkeypatch.setattr(moe, "route", forced)
    want, wm = lm.make_train_step(cfg, opt)(fresh(), {"tokens": toks})
    monkeypatch.undo()
    assert next(left, None) is None          # every forced routing taken
    for k in ("loss", "grad_norm"):
        assert abs(float(gm[k]) - float(wm[k])) <= 2e-5 * abs(float(wm[k]))
    for a, b in zip(tree.leaves(sharding.gather(got.opt_state)),
                    tree.leaves(want.opt_state)):
        assert float((a.float() - b.float()).abs().max()) <= 2e-5
    for placed in (got.params, got.opt_state):
        per = [tree.named_values(sh) for sh in placed.shards]
        for i, sp in enumerate(tree.named_values(placed.specs)):
            for ks in sharding.holders(sp, mesh):
                for k in ks[1:]:
                    assert torch.equal(per[k][i], per[ks[0]][i])
    for sh in got.params.shards:
        for t, full, sp in zip(tree.named_values(sh),
                               tree.named_values(params),
                               tree.named_values(got.params.specs)):
            assert t.is_cuda and tuple(t.shape) == sharding.local_shape(
                full.shape, sp, mesh)


@pytest.mark.parametrize("arch", ["jamba_1p5_large_398b", "xlstm_1p3b",
                                  "pixtral_12b", "whisper_medium"])
def test_meshed_family_step_on_card_matches_unmeshed(arch, cuda_device,
                                                     monkeypatch):
    """A reduced model of each family (fp32, TF32 off) on a virtual (2, 2)
    mesh of the card against the unmeshed run on the card: with the flash
    threshold below the prompt every causal attention layer launches the
    kernel once per device on its head group, the prefill and 4 serve
    steps within 1e-4 of the largest logit, every replica of the decode
    state (xLSTM's whole states included) bit-equal, and one AdamW step's
    loss and grad norm within 2e-5.  Jamba's experts get room for every
    token, so the mesh's blocks drop nothing."""
    import dataclasses
    from repro_torch.models import attention, lm, sharding
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 32)
    params = lm.init_model(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     generator=gen, device=cuda_device)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (2, cfg.num_patch_tokens, cfg.d_model), generator=gen,
            device=cuda_device)
    if cfg.is_encdec:
        batch["enc_frames"] = torch.randn((2, 24, cfg.d_model),
                                          generator=gen, device=cuda_device)
    mesh = _virtual_card_mesh(cuda_device)
    placed = lm.place_params(params, cfg, mesh)
    kernels.reset_launch_counts()
    got = lm.prefill(placed, cfg, batch, mesh=mesh)
    torch.cuda.synchronize()
    causal = sum(s.mixer in ("attn", "attn_local") for s in cfg.layout())
    assert kernels.launch_counts()["flash_attention"] == causal * mesh.size
    want = lm.prefill(params, cfg, batch)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())

    frames = batch.get("enc_frames")
    st = lm.init_decode_state(placed, cfg, 2, 4, enc_frames=frames,
                              mesh=mesh)
    st0 = lm.init_decode_state(params, cfg, 2, 4, enc_frames=frames)
    step, step0 = lm.make_serve_step(cfg, mesh), lm.make_serve_step(cfg)
    for t in range(4):
        a, st = step(placed, st, batch["tokens"][:, t:t + 1])
        b, st0 = step0(params, st0, batch["tokens"][:, t:t + 1])
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    per = [tree.named_values(sh) for sh in st.stack.shards]
    for i, sp in enumerate(tree.named_values(st.stack.specs)):
        for ks in sharding.holders(sp, mesh):
            assert all(per[k][i].is_cuda and torch.equal(per[k][i],
                                                         per[ks[0]][i])
                       for k in ks)

    opt = adamw(1e-3)

    def fresh():
        return lm.TrainState(params, opt.init(params), torch.zeros(
            (), dtype=torch.int32, device=cuda_device))

    _, gm = lm.make_train_step(cfg, opt, mesh=mesh)(
        lm.place_train_state(fresh(), cfg, mesh), batch)
    _, wm = lm.make_train_step(cfg, opt)(fresh(), batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(gm[k]) - float(wm[k])) <= 2e-5 * abs(float(wm[k]))


# ------------------------------------------- obs: spans timed on the device

def test_traced_spans_on_card_carry_device_times_and_syncs(cuda_device,
                                                            tmp_path):
    """Two engine rounds of the quickstart on the card with
    ``ObsConfig(trace=True)``: every span has device times no earlier
    than its host start less 0.1 ms, ``engine_step`` is charged at least
    the two syncs of its stagings (the dropout rates and the weights,
    copied from pageable host memory), and the run puts the sync debug
    mode and the warning filters back."""
    import warnings

    from repro_torch.obs import ObsConfig, read_events
    from repro_torch.quickstart import run

    log = tmp_path / "run.jsonl"
    mode, filters = torch.cuda.get_sync_debug_mode(), list(warnings.filters)
    run(2, fedavg_rounds=0, obs=ObsConfig(trace=True, jsonl_path=str(log)),
        device=cuda_device)
    assert torch.cuda.get_sync_debug_mode() == mode
    assert warnings.filters == filters
    events = read_events(str(log))
    spans = [e for e in events if e["event"] == "span"]
    timed = [e for e in spans if e["name"] != "outside_spans"]
    assert {"local_train", "engine_step", "host_transfer",
            "allocate"} <= {e["name"] for e in timed}
    for e in timed:
        assert e["device_ns"] is not None, e
        assert e["device_ns"][0] >= e["host_ns"][0] - 100_000, e
        assert e["device_ns"][0] <= e["device_ns"][1], e
    steps = [e for e in timed if e["name"] == "engine_step"]
    assert len(steps) == 2 and all(e["syncs"] >= 2 for e in steps), steps
    sites = events[-1]["sync_sites"]
    assert sum(sites.values()) >= sum(e["syncs"] for e in spans) > 0
