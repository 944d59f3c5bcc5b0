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
    go through all three kernels and keep the model there."""
    from repro_torch.quickstart import run
    kernels.reset_launch_counts()
    feddd, fedavg, _ = run(2, fedavg_rounds=1, device=cuda_device)
    assert all(v > 0 for v in kernels.launch_counts().values())
    assert all(np.isfinite(r.mean_loss) for r in feddd.history)
    assert all(leaf.is_cuda for leaf in tree.leaves(fedavg.global_params))
