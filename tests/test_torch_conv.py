"""The client-batched convolutions (``repro_torch.kernels.conv``) on the
CPU: ``conv2d_same`` inside and outside ``torch.func`` transforms against
``F.conv2d`` bit for bit, the routing of its ``vmap`` rules, the plain
passes against autograd in float64, and the wgrad split plan.  The
kernels themselves run in ``tests/test_torch_cuda.py``."""

import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch import kernels, tree
from repro_torch.fl import models
from repro_torch.kernels.conv import ops, ref

# (spec, image side, image channels): the paper's CNN1 and CNN2 and the
# narrowest hetero-a VGG
SPECS = {"cnn1": (models.CNN1_SPEC, 16, 1), "cnn2": (models.CNN2_SPEC, 32, 3),
         "vgg": (models.HETERO_A_SPECS[4], 32, 3)}


def _f_conv2d(x, w):
    return F.conv2d(x, w, padding="same")


def _fleet(name, n=3, b=4, seed=0):
    spec, side, ch = SPECS[name]
    gen = torch.Generator().manual_seed(seed)
    params = models.init_cnn_spec(spec, seed=seed, device="cpu")
    stacked = tree.tree_map(lambda t: t + 0.01 * torch.randn(
        (n,) + t.shape, generator=gen), params)
    x = torch.randn((n, b, side, side, ch), generator=gen)
    y = torch.randint(0, 10, (n, b), generator=gen)
    return spec, stacked, x, y


def _vmapped_step(spec):
    def step(p, xb, yb):
        return torch.func.grad_and_value(
            lambda q: models._ce(models.apply_spec(q, spec, xb), yb))(p)
    return torch.func.vmap(step)


def _flat(out):
    grads, loss = out
    return tree.leaves(grads) + [loss]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_vmapped_step_equals_vmapped_f_conv2d_bitwise(name, monkeypatch):
    """vmap(grad_and_value) through ``conv2d_same`` (its ``vmap`` rules on
    the CPU route) reads the bits of the vmapped ``F.conv2d`` it
    replaced: every gradient and the loss."""
    spec, stacked, x, y = _fleet(name)
    got = _flat(_vmapped_step(spec)(stacked, x, y))
    monkeypatch.setattr(models, "conv2d_same", _f_conv2d)
    want = _flat(_vmapped_step(spec)(stacked, x, y))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", ["cnn1", "cnn2"])
def test_apply_spec_outside_vmap_is_f_conv2d_bitwise(name, monkeypatch):
    """Outside transforms ``apply_spec`` runs today's ops: the per-client
    trainer's forward and autograd gradients, and eval under no_grad,
    are bit-equal to ``F.conv2d``'s."""
    spec, stacked, x, y = _fleet(name, n=1)
    params = tree.tree_map(lambda t: t[0].requires_grad_(True), stacked)

    def run():
        out = models.apply_spec(params, spec, x[0])
        grads = torch.autograd.grad(models._ce(out, y[0]),
                                    tree.leaves(params))
        with torch.no_grad():
            ev = models.apply_spec(params, spec, x[0])
        return [out.detach(), ev, *grads]

    got = run()
    monkeypatch.setattr(models, "conv2d_same", _f_conv2d)
    want = run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_grad_without_vmap_equals_autograd_bitwise():
    """Under ``torch.func.grad`` alone the Function's passes read the
    bits of ``F.conv2d``'s autograd backward (its combined call)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((4, 3, 9, 9), generator=gen)
    w = torch.randn((5, 3, 3, 3), generator=gen)

    def loss(conv):
        return lambda w_, x_: (conv(x_, w_) ** 2).sum()

    got = torch.func.grad(loss(ops.conv2d_same), argnums=(0, 1))(w, x)
    want = torch.func.grad(loss(_f_conv2d), argnums=(0, 1))(w, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_no_conv_launch_on_the_cpu():
    spec, stacked, x, y = _fleet("cnn2")
    kernels.reset_launch_counts()
    _vmapped_step(spec)(stacked, x, y)
    assert kernels.launch_counts()["conv"] == 0
    assert set(ops.route_counts().values()) == {0}


def test_card_route_takes_each_pass_once_a_layer(monkeypatch):
    """With the card's route forced on the CPU (the batched passes
    standing in as their plain versions), one vmapped CNN2 step routes 3
    forward, 2 input-gradient (the images take none) and 3
    weight-gradient passes there, hands each operand client-first in
    the layout the kernels read, and takes the gradients they return to
    within float32 round-off of the CPU route's."""
    calls = []

    def fprop(x, w):
        calls.append("fprop")
        assert x.shape[0] == w.shape[0] == 3 and w.ndim == x.ndim == 5
        return ref.conv_fprop_ref(x, w)

    def dgrad(g, w):
        calls.append("dgrad")
        return ref.conv_dgrad_ref(g, w)

    def wgrad(x, g, k):
        calls.append("wgrad")
        out = ref.conv_wgrad_ref(x, g, k)        # the kernel's layout
        return out.permute(0, 3, 4, 2, 1).contiguous().permute(0, 4, 3, 1, 2)

    spec, stacked, x, y = _fleet("cnn2")
    want = _flat(_vmapped_step(spec)(stacked, x, y))
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "fprop_batched", fprop)
    monkeypatch.setattr(ops, "dgrad_batched", dgrad)
    monkeypatch.setattr(ops, "wgrad_batched", wgrad)
    got = _flat(_vmapped_step(spec)(stacked, x, y))
    assert sorted(calls) == ["dgrad"] * 2 + ["fprop"] * 3 + ["wgrad"] * 3
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_shared_weights_stay_on_the_plain_route(monkeypatch):
    """vmap over images with one set of weights (no client dimension on
    them): the batch is folded into ``F.conv2d``, bit-equal to vmapping
    it, and no batched pass is asked for even on the card's route."""
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    for name in ("fprop_batched", "dgrad_batched", "wgrad_batched"):
        monkeypatch.setattr(ops, name, None)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((3, 2, 4, 8, 8), generator=gen)
    w = torch.randn((6, 4, 3, 3), generator=gen)

    def loss(conv):
        return lambda x_: (conv(x_, w) ** 2).sum()

    got = torch.func.vmap(torch.func.grad(loss(ops.conv2d_same)))(x)
    want = torch.func.vmap(torch.func.grad(loss(_f_conv2d)))(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,b,c,o,h,wd,k", [
    (2, 3, 3, 16, 8, 8, 3), (1, 2, 5, 7, 7, 5, 5), (2, 1, 4, 3, 6, 6, 1),
    (3, 2, 2, 5, 5, 9, 7)])
def test_plain_passes_match_autograd_in_float64(n, b, c, o, h, wd, k):
    """``ref.py``'s three passes equal ``F.conv2d`` and its autograd
    gradients per client, in float64, for odd kernels and ragged
    images."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((n, b, c, h, wd), generator=gen, dtype=torch.float64)
    w = torch.randn((n, o, c, k, k), generator=gen, dtype=torch.float64)
    g = torch.randn((n, b, o, h, wd), generator=gen, dtype=torch.float64)
    outs, gxs, gws = [], [], []
    for xi, wi, gi in zip(x, w, g):
        xi, wi = xi.clone().requires_grad_(True), wi.clone().requires_grad_(
            True)
        out = F.conv2d(xi, wi, padding="same")
        gx, gw = torch.autograd.grad(out, (xi, wi), gi)
        outs.append(out.detach())
        gxs.append(gx)
        gws.append(gw)
    for got, want in ((ref.conv_fprop_ref(x, w), outs),
                      (ref.conv_dgrad_ref(g, w), gxs),
                      (ref.conv_wgrad_ref(x, g, k), gws)):
        torch.testing.assert_close(got, torch.stack(want), rtol=1e-12,
                                   atol=1e-11)


def test_double_backward_through_the_passes():
    """Each pass's backward is made of the passes: the vmapped Hessian of
    a conv net's loss in its weights, and the mixed second derivative in
    the inputs, equal ``F.conv2d``'s in float64."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 3, 2, 5, 5), generator=gen, dtype=torch.float64)
    w = torch.randn((2, 4, 2, 3, 3), generator=gen, dtype=torch.float64)

    def loss(conv):
        return lambda w_, x_: (torch.tanh(conv(x_, w_)) ** 2).sum()

    for argnums in (0, 1):
        got, want = (torch.func.vmap(torch.func.jacrev(torch.func.grad(
            loss(conv), argnums=0), argnums=argnums))(w, x)
            for conv in (ops.conv2d_same, _f_conv2d))
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_weight_gradient_of_no_image_is_zero():
    """A batch of no images reduces over no pixel: zeros, no launch."""
    got = ops.wgrad_batched(torch.zeros((2, 0, 3, 4, 4)),
                            torch.zeros((2, 0, 5, 4, 4)), 3)
    assert got.shape == (2, 5, 3, 3, 3) and not got.any()


def test_even_kernels_and_other_dtypes_raise():
    w = torch.zeros((2, 3, 2, 2))
    with pytest.raises(ValueError, match="odd"):
        torch.func.grad(lambda w_: ops.conv2d_same(
            torch.zeros((1, 3, 4, 4)), w_).sum())(w)
    x = torch.zeros((2, 1, 3, 4, 4), dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ops.fprop_batched(x, torch.zeros((2, 2, 3, 3, 3),
                                         dtype=torch.float64))


# the cell's three convs at 100 clients x 50 images on 132 SMs
CELL_PLANS = {(51200, 27, 16): (32, 16, 8, 1, 11, 4672),
              (12800, 144, 32): (64, 32, 2, 3, 4, 3200),
              (3200, 288, 64): (64, 64, 1, 5, 3, 1072)}


@pytest.mark.parametrize("shape", sorted(CELL_PLANS))
def test_wgrad_plan_at_the_cell(shape):
    """Every CNN2 weight gradient splits on an H100, so a vmapped step
    launches 3 sums of partials beside its 3 weight-gradient passes."""
    assert tuple(ops.wgrad_plan(100, *shape, sms=132)) == CELL_PLANS[shape]


@pytest.mark.parametrize("clients,pixels,k2c,out_ch,sms", [
    (1, 1, 9, 1, 132), (100, 51200, 27, 16, 132), (7, 999, 4608, 512, 132),
    (1, 1 << 20, 75, 10, 8), (64, 64, 200, 70, 1)])
def test_wgrad_plan_covers_every_pixel_once(clients, pixels, k2c, out_ch,
                                            sms):
    p = ops.wgrad_plan(clients, pixels, k2c, out_ch, sms)
    assert p.rows == (32 if k2c <= 32 else 64)
    assert p.cols == min(c for c in (16, 32, 64, math.inf)
                         if c >= min(out_ch, 64))
    assert p.groups * (p.rows // 32) * (p.cols // 16) == 8
    assert p.per_split % (p.groups * ops.WGRAD_CHUNK) == 0
    assert (p.splits - 1) * p.per_split < pixels <= p.splits * p.per_split
