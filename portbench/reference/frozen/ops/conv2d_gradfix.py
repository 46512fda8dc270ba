"""2D convolutions differentiable to any order on the fast kernels.

The path-length and R1 penalties differentiate the networks twice.  Stock
autograd runs the second-order pass of a convolution through
``aten::_convolution_double_backward``, which computes the weight gradient
of the first backward as a forward convolution whose filter is the whole
output gradient; cuDNN has no fast algorithm for that and falls back to a
generic implicit GEMM, which dominated the path-length and R1 phases at
FFHQ-1024 on the H100.  Here a convolution, its input gradient and its
weight gradient are three ``torch.autograd.Function``s whose backwards are
each other, so every order runs ``aten::convolution`` and
``aten::convolution_backward``: the kernels of a first-order step.  Numerics are those of the stock ops.
StyleGAN2-ADA's ``conv2d_gradfix`` answers the same problem the same way.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import torch


class _Params(NamedTuple):
    stride: Tuple[int, int]
    padding: Tuple[int, int]
    transposed: bool
    output_padding: Tuple[int, int]
    groups: int


_DILATION = (1, 1)


def _aten_backward(gy, x, w, p: _Params, mask):
    return torch.ops.aten.convolution_backward(
        gy, x, w, None, p.stride, p.padding, _DILATION, p.transposed,
        p.output_padding, p.groups, mask)


class _Conv(torch.autograd.Function):
    """y = conv(x, w)."""

    @staticmethod
    def forward(ctx, x, w, p: _Params):
        ctx.save_for_backward(x, w)
        ctx.p = p
        return torch.ops.aten.convolution(
            x, w, None, p.stride, p.padding, _DILATION, p.transposed,
            p.output_padding, p.groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _ConvGradInput.apply(gy, x, w, ctx.p)
        if ctx.needs_input_grad[1]:
            gw = _ConvGradWeight.apply(gy, x, w, ctx.p)
        return gx, gw, None


class _ConvGradInput(torch.autograd.Function):
    """gx = (d conv(x, w) / dx)^T gy; ``x`` gives the shape only."""

    @staticmethod
    def forward(ctx, gy, x, w, p: _Params):
        ctx.save_for_backward(gy, w)
        ctx.p = p
        return _aten_backward(gy, x, w, p, [True, False, False])[0]

    @staticmethod
    def backward(ctx, ggx):
        gy, w = ctx.saved_tensors
        g_gy = g_w = None
        if ctx.needs_input_grad[0]:
            g_gy = _Conv.apply(ggx, w, ctx.p)
        if ctx.needs_input_grad[2]:
            g_w = _ConvGradWeight.apply(gy, ggx, w, ctx.p)
        return g_gy, None, g_w, None


class _ConvGradWeight(torch.autograd.Function):
    """gw = (d conv(x, w) / dw)^T gy; ``w`` gives the shape only."""

    @staticmethod
    def forward(ctx, gy, x, w, p: _Params):
        ctx.save_for_backward(gy, x, w)
        ctx.p = p
        return _aten_backward(gy, x, w, p, [False, True, False])[1]

    @staticmethod
    def backward(ctx, ggw):
        gy, x, w = ctx.saved_tensors
        g_gy = g_x = None
        if ctx.needs_input_grad[0]:
            g_gy = _Conv.apply(x, ggw, ctx.p)
        if ctx.needs_input_grad[1]:
            g_x = _ConvGradInput.apply(gy, x, ggw, ctx.p)
        return g_gy, g_x, None, None


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(t) for t in v)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
           groups: int = 1) -> torch.Tensor:
    """``F.conv2d(x, w, stride=stride, padding=padding, groups=groups)``."""
    x, w = _rounded(x, w)
    return _Conv.apply(x, w, _Params(_pair(stride), _pair(padding), False,
                                     (0, 0), groups))


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
                     output_padding=0, groups: int = 1) -> torch.Tensor:
    """``F.conv_transpose2d(x, w, stride=..., padding=..., output_padding=...,
    groups=...)``."""
    x, w = _rounded(x, w)
    return _Conv.apply(x, w, _Params(_pair(stride), _pair(padding), True,
                                     _pair(output_padding), groups))

class Rounding:
    """The control's operand rounding (not in the package), one precision
    below the configuration's: ``block`` ("fp8", set per block by the
    models from ``fp8_resolution``) rounds a convolution's input and
    weight to float8 e4m3; outside such blocks ``default`` ("bf16") rounds
    them to bfloat16; ``fc`` ("bf16") the linear layers' operands; ``clip``
    ("fp8") the CLIP tower's linear layers'.  None leaves them alone."""
    block = None
    default = None
    fc = None
    clip = None


@contextlib.contextmanager
def control_rounding():
    """The control's rounding for the length of the block."""
    saved = (Rounding.default, Rounding.fc, Rounding.clip)
    Rounding.default, Rounding.fc, Rounding.clip = "bf16", "bf16", "fp8"
    try:
        yield
    finally:
        Rounding.default, Rounding.fc, Rounding.clip = saved


def rounded(mode, *ts):
    if mode == "fp8":
        return tuple(fake_fp8(t) for t in ts)
    if mode == "bf16":
        return tuple(round_bf16(t) for t in ts)
    return ts


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale to its largest
    magnitude (448), in ``t``'s dtype; the gradient passes straight
    through."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / 448.0
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, in ``t``'s dtype (gradient straight
    through)."""
    return t + (t.detach().to(torch.bfloat16).to(t.dtype) - t).detach()


def _rounded(x, w):
    return rounded(Rounding.block or Rounding.default, x, w)
