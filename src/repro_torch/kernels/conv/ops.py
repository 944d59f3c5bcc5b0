"""SAME convolutions whose weights carry a client dimension, as
``torch.func.vmap`` of a per-client training step makes them
(``csrc/conv.cu``).

:func:`conv2d_same` is ``F.conv2d(x, w, padding="same")`` for an NCHW
``x`` and an OIHW ``w`` of odd square size, stride and dilation 1.
Outside any ``torch.func`` transform it is that call and nothing else.
Under one it is an autograd ``Function`` whose three passes (forward,
input gradient, weight gradient) are ``Function``\\ s of their own, each
with a ``vmap`` rule that routes by what it is handed:

* weights with a client dimension on a CUDA card: the client-batched
  kernels, one launch a pass for the whole fleet (the weight gradient
  adds one launch that sums its partials, where it splits);
* weights with a client dimension elsewhere, or without one:
  ``torch.func.vmap`` of the plain ATen call, the computation a vmapped
  ``F.conv2d`` and its autograd backward make.

The input gradient is computed only where ``needs_input_grad`` asks for
it (a network's images take none).  The passes are linear in each
operand, so each one's backward is again made of the three passes.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _lib

WGRAD_CHUNK = 8          # pixels a wgrad group reduces per step (kChunk)
WGRAD_BLOCKS_PER_SM = 8  # the wgrad split aims at this many blocks per SM
WGRAD_MIN_STEPS = 16     # and leaves each split at least these steps
MAX_OFFSET = 1 << 31     # per-client offsets are 32-bit in the kernels
MAX_CLIENTS = 65535      # the grid's z extent


class WgradPlan(NamedTuple):
    rows: int          # TR: weight rows (k k C) of a block's tile
    cols: int          # TC: output channels of the tile
    groups: int        # warp groups of a block, each its own pixels
    tiles: int         # tiles of the (k k C, O) weight gradient
    splits: int        # blocks that split one client's pixels
    per_split: int     # pixels of each split (the last may have fewer)


def wgrad_plan(clients: int, pixels: int, k2c: int, out_ch: int,
               sms: int) -> WgradPlan:
    """How the weight gradient's reduction over ``pixels`` = B H W of
    each client is cut: tiles of TR x TC, a block of 8 warps made of
    ``groups`` groups that each cover TR x TC and reduce their own
    pixels (summed in the block at its end, in group order), and
    ``splits`` blocks a tile and client, so that the grid reaches
    WGRAD_BLOCKS_PER_SM blocks per SM, each split at least
    WGRAD_MIN_STEPS steps of a group's WGRAD_CHUNK pixels; a second
    launch sums the splits in their order."""
    rows = 32 if k2c <= 32 else 64
    cols = 16 if out_ch <= 16 else 32 if out_ch <= 32 else 64
    groups = 8 // ((rows // 32) * (cols // 16))
    tiles = math.ceil(k2c / rows) * math.ceil(out_ch / cols)
    step = groups * WGRAD_CHUNK
    splits = max(1, min(
        math.ceil(WGRAD_BLOCKS_PER_SM * sms / (clients * tiles)),
        pixels // (step * WGRAD_MIN_STEPS)))
    per = math.ceil(math.ceil(pixels / splits) / step) * step
    return WgradPlan(rows, cols, groups, tiles, math.ceil(pixels / per),
                     per)


def _pad(k: int) -> int:
    if k % 2 == 0:
        raise ValueError(f"conv2d_same takes odd kernel sizes, not {k}")
    return (k - 1) // 2


def _span(t: torch.Tensor, dims) -> int:
    """The largest element offset of ``t`` over ``dims``."""
    return sum((t.shape[d] - 1) * abs(t.stride(d)) for d in dims)


def _check(**tensors: torch.Tensor) -> None:
    dev = tensors[next(iter(tensors))].device
    for name, t in tensors.items():
        _lib.check_dtype(name, t, (torch.float32,))
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, not {dev}")
        if _span(t, range(1, t.ndim)) >= MAX_OFFSET:
            raise ValueError(f"{name}: a client's extent reaches 2**31 "
                             f"elements")
    n = tensors[next(iter(tensors))].shape[0]
    if not 1 <= n <= MAX_CLIENTS:
        raise ValueError(f"{n} clients: the kernels take 1 to "
                         f"{MAX_CLIENTS}")


def _act(t: torch.Tensor):
    """Client, batch, channel, row and column strides of (N, B, C, H, W)."""
    return [t.stride(i) for i in range(5)]


def _fprop(x: torch.Tensor, w: torch.Tensor, w_at: torch.Tensor,
           w_strides, out_ch: int, route: str) -> torch.Tensor:
    """The forward kernel: out[n, b, o, y, x] = sum over (ky, kx, c) of
    x[n, b, c, y + ky - p, x + kx - p] * W(n, ky, kx, c, o), with W read
    from the first element of ``w_at`` at the client, output-channel,
    input-channel, row and column strides ``w_strides`` (the input
    gradient passes the flipped, transposed weights ``w`` this way)."""
    n, b, c, h, wd = x.shape
    k = w.shape[-1]
    if b * out_ch * h * wd >= MAX_OFFSET:
        raise ValueError("a client's output reaches 2**31 elements")
    out = torch.empty((n, b, out_ch, h, wd), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    desc = (ctypes.c_int64 * 18)(n, b, c, h, wd, out_ch, k, _pad(k),
                                 *_act(x), *w_strides)
    _lib.launch("conv", "feddd_conv_fprop", x.data_ptr(),
                w_at.data_ptr(), out.data_ptr(), desc, device=x.device,
                route=route)
    return out


def fprop_batched(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, B, C, H, W), w (N, O, C, k, k), any strides, float32 on one
    card -> (N, B, O, H, W), contiguous."""
    _check(x=x, w=w)
    o = w.shape[1]
    sn, so, sc, sh, sw = (w.stride(i) for i in range(5))
    return _fprop(x, w, w, (sn, so, sc, sh, sw), o, "fprop")


def dgrad_batched(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g (N, B, O, H, W), w (N, O, C, k, k) -> the input gradient
    (N, B, C, H, W): the forward kernel over g with the weights flipped
    in both taps and transposed, read in place through negative tap
    strides from the last tap."""
    _check(g=g, w=w)
    k = w.shape[-1]
    sn, so, sc, sh, sw = (w.stride(i) for i in range(5))
    last = w[:, :, :, k - 1:, k - 1:]     # its first element: the last tap
    return _fprop(g, w, last, (sn, sc, so, -sh, -sw), w.shape[2], "dgrad")


def wgrad_batched(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """x (N, B, C, H, W), g (N, B, O, H, W) -> the weight gradient
    (N, O, C, k, k), a view of a contiguous (N, k, k, C, O)."""
    _check(x=x, g=g)
    n, b, c, h, wd = x.shape
    o = g.shape[2]
    out = torch.empty((n, k, k, c, o), dtype=x.dtype, device=x.device)
    view = out.permute(0, 4, 3, 1, 2)
    pixels = b * h * wd
    if pixels == 0:                  # no image: a gradient of zeros
        return view.zero_()
    plan = wgrad_plan(n, pixels, k * k * c, o,
                      torch.cuda.get_device_properties(
                          x.device).multi_processor_count)
    part = out if plan.splits == 1 else torch.empty(
        (n, plan.splits, k * k * c, o), dtype=x.dtype, device=x.device)
    desc = (ctypes.c_int64 * 20)(n, b, c, h, wd, o, k, _pad(k), *_act(x),
                                 *_act(g), plan.splits, plan.per_split)
    _lib.launch("conv", "feddd_conv_wgrad", x.data_ptr(), g.data_ptr(),
                part.data_ptr(), desc, device=x.device, route="wgrad")
    if plan.splits > 1:
        _lib.launch("conv", "feddd_conv_wgrad_reduce", part.data_ptr(),
                    out.data_ptr(), n, plan.splits, k * k * c * o,
                    device=x.device, route="wgrad_reduce")
    return view


def route_counts():
    """Launches by pass (fprop, dgrad, wgrad, wgrad_reduce) since
    ``kernels.reset_launch_counts``."""
    return _lib.route_launches("conv", ("fprop", "dgrad", "wgrad",
                                        "wgrad_reduce"))


# ---------------------------------------------------------------- autograd

_STRIDE, _DILATION, _NO_PAD = [1, 1], [1, 1], [0, 0]


def _fprop_plain(x, w):
    return F.conv2d(x, w, padding="same")


def _backward_plain(g, x, w, mask):
    p = _pad(w.shape[-1])
    return torch.ops.aten.convolution_backward(
        g, x, w, None, _STRIDE, [p, p], _DILATION, False, _NO_PAD, 1, mask)


def _dgrad_plain(g, x, w):
    return _backward_plain(g, x, w, [True, False, False])[0]


def _wgrad_plain(x, g, w):
    return _backward_plain(g, x, w, [False, True, False])[1]


def _clients_first(t: torch.Tensor, dim, n: int) -> torch.Tensor:
    if dim is None:
        return t.unsqueeze(0).expand(n, *t.shape)
    return t.movedim(dim, 0)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _vmap_rule(plain, batched):
    """The ``vmap`` rule of a pass whose operands end with the weights:
    ``batched`` (on client-first operands) where the weights carry a
    client dimension and the tensors lie on a CUDA card, else
    ``torch.func.vmap`` of ``plain``."""
    def rule(info, in_dims, *args):
        if in_dims[-1] is not None and _on_card(args[-1]):
            return batched(*(_clients_first(t, d, info.batch_size)
                             for t, d in zip(args, in_dims))), 0
        return torch.func.vmap(plain, in_dims=in_dims,
                               randomness=info.randomness)(*args), 0
    return staticmethod(rule)


class _Fprop(torch.autograd.Function):
    """conv(x, w)."""

    @staticmethod
    def forward(x, w):
        return _fprop_plain(x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (_Dgrad.apply(g, x, w) if ctx.needs_input_grad[0] else None,
                _Wgrad.apply(x, g, w) if ctx.needs_input_grad[1] else None)

    vmap = _vmap_rule(_fprop_plain,
                      lambda x, w: fprop_batched(x, w))


class _Dgrad(torch.autograd.Function):
    """The input gradient of conv(x, w) for the output gradient g; x
    gives its shape only."""

    @staticmethod
    def forward(g, x, w):
        return _dgrad_plain(g, x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, u):
        g, x, w = ctx.saved_tensors
        return (_Fprop.apply(u, w) if ctx.needs_input_grad[0] else None,
                None,
                _Wgrad.apply(u, g, w) if ctx.needs_input_grad[2] else None)

    vmap = _vmap_rule(_dgrad_plain,
                      lambda g, x, w: dgrad_batched(g, w))


class _Wgrad(torch.autograd.Function):
    """The weight gradient of conv(x, w) for the output gradient g; w
    gives its shape only."""

    @staticmethod
    def forward(x, g, w):
        return _wgrad_plain(x, g, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, v):
        x, g, w = ctx.saved_tensors
        return (_Dgrad.apply(g, x, v) if ctx.needs_input_grad[0] else None,
                _Fprop.apply(x, v) if ctx.needs_input_grad[1] else None,
                None)

    vmap = _vmap_rule(_wgrad_plain,
                      lambda x, g, w: wgrad_batched(x, g, w.shape[-1]))


def conv2d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.conv2d(x, w, padding="same")``: x (B, C, H, W), w (O, C, k, k)
    with k odd, any strides.  Outside ``torch.func`` transforms it is
    that call; under them :class:`_Fprop`, whose passes take the
    client-batched kernels where a ``vmap`` gives the weights a client
    dimension on a card."""
    if torch._C._functorch.peek_interpreter_stack() is None:
        return F.conv2d(x, w, padding="same")
    _pad(w.shape[-1])
    return _Fprop.apply(x, w)
