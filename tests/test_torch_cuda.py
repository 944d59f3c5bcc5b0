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
    go through all three FedDD kernels (and not flash attention) and keep
    the model there."""
    from repro_torch.quickstart import run
    kernels.reset_launch_counts()
    feddd, fedavg, _ = run(2, fedavg_rounds=1, device=cuda_device)
    counts = kernels.launch_counts()
    assert counts.pop("flash_attention") == 0
    assert all(v > 0 for v in counts.values())
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
