"""Fused modulated-conv synthesis level: the counterpart of
gagan_tpu/ops/pallas_modconv.py, with a CUDA C++ kernel for Hopper
(``csrc/fused_modconv.cu``) in place of the Pallas TPU kernel.

One op computes the stride-1 3x3 SynthesisLayer hot path,

    y = clamp(act_gain * lrelu(dcoef * conv3x3(styles * x, W) + noise + bias))

reading x once and writing y once; modulation and demodulation are folded
into the weight taps in fp32 and rounded to ``x.dtype`` (as the Pallas
kernel does), and the products accumulate in fp32.

The kernel is two launches: ``fold_taps`` folds the taps into a scratch
(bf16 [N, 9, C_out, C_in]; fp32 [N, 9, C_in, C_out], output channels
innermost), then the convolution reads them (bf16: TMA + wgmma; fp32: FFMA
from a sliding register window, 8-channel K chunks).  ``fused_modconv3x3``
runs both on CUDA tensors and its plain PyTorch version
``fused_modconv3x3_ref`` on CPU tensors; a CUDA tensor never takes the
plain version.  Forward only: the composed backward
(pallas_modconv.py::_bwd) comes with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.observability import trace_scope
from .modulated_conv2d import demod_coefs

LRELU_SLOPE = 0.2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_K_CHUNK = 16      # C_in must be a multiple of this (whole fp32 K chunks of 8)
_BM = 128          # output channels per block of the kernel


def supported_shape(x_shape, w_shape, up: int = 1, down: int = 1) -> bool:
    """Whether the fused kernel serves this level (else the composed path).

    Accepts every shape that the Pallas kernel's ``supported_shape`` accepts
    and more, since nothing on Hopper needs the TPU's (8, 128) tiling: W >= 128
    need only be a multiple of 8 (16-byte TMA strides and x loads), C_in
    a multiple of 16 (whole 8-channel K chunks of the fp32 kernel; the bf16
    kernel zero-fills its 64-channel chunks), and H is free (ragged pixel
    tiles read zeros and are clipped on store).  C_out stays a multiple of
    128, the kernel's channel tile, so no level pays for a half-empty tile,
    and W >= 128 keeps the kernel to the high-resolution levels where its
    per-sample tap fold is small beside the convolution.  At FFHQ-1024 it
    serves b128.conv1 and b256.conv1, as the Pallas kernel does.
    """
    n, c_in, h, w = x_shape
    c_out, c_in2, kh, kw = w_shape
    return (up == 1 and down == 1 and kh == 3 and kw == 3 and c_in == c_in2
            and c_in % _K_CHUNK == 0 and c_out % _BM == 0 and w >= 128
            and w % 8 == 0)


def _fold_taps_ref(w, styles, dcoefs, dtype) -> torch.Tensor:
    """taps [N, 9, C_out, C_in] = dtype((w * styles) * dcoefs), in fp32."""
    taps = w.float()[None] * styles.float()[:, None, :, None, None]
    taps = taps * dcoefs.float()[:, :, None, None, None]     # [N, O, I, 3, 3]
    return taps.flatten(3).permute(0, 3, 1, 2).to(dtype)


def fused_modconv3x3_ref(x, w, styles, dcoefs, noise, bias,
                         act_gain=float(np.sqrt(2.0)), act_slope=LRELU_SLOPE,
                         clamp: Optional[float] = 256.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel, rounding at the same places."""
    n, c_in, h, wd = x.shape
    c_out = w.shape[0]
    taps = _fold_taps_ref(w, styles, dcoefs, x.dtype).float()
    taps = taps.permute(0, 2, 3, 1)                          # [N, O, I, 9]
    y = F.conv2d(x.float().reshape(1, n * c_in, h, wd),
                 taps.reshape(n * c_out, c_in, 3, 3), padding=1, groups=n)
    y = y.reshape(n, c_out, h, wd)
    if noise is not None:
        y = y + noise.float()
    y = y + bias.float()[None, :, None, None]
    y = act_gain * (torch.clamp_min(y, 0.0) + act_slope * torch.clamp_max(y, 0.0))
    if clamp is not None:
        y = torch.clamp(y, -clamp, clamp)
    return y.to(x.dtype)


def _check(x, w, styles, dcoefs, noise, bias):
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_modconv3x3 takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    n, c_in, h, wd = x.shape
    c_out = w.shape[0]
    if c_in % _K_CHUNK:
        raise ValueError(f"C_in={c_in} is not a multiple of {_K_CHUNK}")
    if x.dtype == torch.bfloat16 and (wd % 8 or c_out % _BM):
        raise ValueError(f"bfloat16 needs W % 8 == 0 and C_out % {_BM} == 0, "
                         f"got W={wd}, C_out={c_out}")
    if x.dtype == torch.float32 and (wd % 4 or c_out % 4):
        raise ValueError(f"float32 needs W % 4 == 0 and C_out % 4 == 0 "
                         f"(16-byte vectors), got W={wd}, C_out={c_out}")
    want = {"w": (w, (c_out, c_in, 3, 3)), "styles": (styles, (n, c_in)),
            "dcoefs": (dcoefs, (n, c_out)), "bias": (bias, (c_out,))}
    if noise is not None:
        want["noise"] = (noise, (n, 1, h, wd))
    _check_f32(x.device, want)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _check_f32(device, want):
    """Each {name: (tensor, shape)} is a contiguous float32 tensor of that
    shape on ``device``."""
    for name, (t, shape) in want.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib():
    from .. import _build

    lib = _build.load("fused_modconv")
    if lib.gagan_fused_modconv3x3_conv.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gagan_fused_modconv3x3_fold.argtypes = [i, p, p, p, p, i, i, i, p]
        lib.gagan_fused_modconv3x3_conv.argtypes = [
            i, p, p, p, p, p, i, i, i, i, i, f, f, f, i, p]
        lib.gagan_fused_modconv3x3_smem_bytes.argtypes = [i]
        for fn in (lib.gagan_fused_modconv3x3_fold,
                   lib.gagan_fused_modconv3x3_conv,
                   lib.gagan_fused_modconv3x3_smem_bytes):
            fn.restype = i
    return lib


def _raise_on(status: int, what: str):
    if status != 0:
        raise RuntimeError(f"fused_modconv3x3 {what} launch failed: "
                           f"CUDA error {status}")


def fold_taps(w, styles, dcoefs, dtype) -> torch.Tensor:
    """The kernel's first launch: the folded taps [N, 9, C_out, C_in] in
    ``dtype`` (float32 or bfloat16), rounded once after the fp32 fold.  On
    the card float32 taps are stored [N, 9, C_in, C_out] (the fp32 kernel's
    layout) and returned as a transposed view."""
    if w.device.type == "cpu":
        return _fold_taps_ref(w, styles, dcoefs, dtype)
    if dtype not in _DTYPES:
        raise TypeError(f"taps are float32 or bfloat16, not {dtype}")
    n, c_in = styles.shape
    c_out = w.shape[0]
    _check_f32(w.device, {"w": (w, (c_out, c_in, 3, 3)),
                          "styles": (styles, (n, c_in)),
                          "dcoefs": (dcoefs, (n, c_out))})
    lib = _lib()
    o_inner = dtype == torch.float32
    shape = (n, 9, c_in, c_out) if o_inner else (n, 9, c_out, c_in)
    with torch.cuda.device(w.device):
        taps = torch.empty(shape, dtype=dtype, device=w.device)
        _raise_on(lib.gagan_fused_modconv3x3_fold(
            _DTYPES[dtype], w.data_ptr(), styles.data_ptr(), dcoefs.data_ptr(),
            taps.data_ptr(), n, c_in, c_out,
            torch.cuda.current_stream(w.device).cuda_stream), "fold")
    return taps.transpose(2, 3) if o_inner else taps


def smem_bytes(dtype) -> int:
    """Dynamic shared memory of the convolution kernel for ``dtype``."""
    return _lib().gagan_fused_modconv3x3_smem_bytes(_DTYPES[dtype])


def _forward(x, w, styles, dcoefs, noise, bias, act_gain, act_slope, clamp):
    if x.device.type == "cpu":
        return fused_modconv3x3_ref(x, w, styles, dcoefs, noise, bias,
                                    act_gain, act_slope, clamp)
    if x.device.type != "cuda":
        raise ValueError(f"fused_modconv3x3 runs on CUDA or CPU, not {x.device}")
    _check(x, w, styles, dcoefs, noise, bias)
    n, c_in, h, wd = x.shape
    c_out = w.shape[0]
    taps = fold_taps(w, styles, dcoefs, x.dtype)
    with torch.cuda.device(x.device):
        y = torch.empty((n, c_out, h, wd), dtype=x.dtype, device=x.device)
        _raise_on(_lib().gagan_fused_modconv3x3_conv(
            _DTYPES[x.dtype], x.data_ptr(), taps.data_ptr(),
            noise.data_ptr() if noise is not None else None,
            bias.data_ptr(), y.data_ptr(), n, c_in, c_out, h, wd,
            float(act_gain), float(act_slope),
            float(clamp) if clamp is not None else 0.0,
            int(clamp is not None),
            torch.cuda.current_stream(x.device).cuda_stream), "conv")
    fused_modconv3x3.launches += 1
    return y


def _act_grad(ypre, act_gain, act_slope, clamp):
    """d act(ypre) / d ypre for the clamped scaled leaky ReLU."""
    slope = torch.where(ypre >= 0, act_gain, act_gain * act_slope)
    if clamp is not None:
        a = act_gain * (torch.clamp_min(ypre, 0) + act_slope
                        * torch.clamp_max(ypre, 0))
        slope = torch.where(a.abs() < clamp, slope, 0.0)
    return slope


def fused_modconv3x3_bwd(x, w, styles, dcoefs, noise, bias, g, act_gain,
                         act_slope, clamp, needs=(True,) * 6):
    """The composed backward (pallas_modconv.py::_bwd) on the forward's
    inputs and the output gradient ``g``: (dx, dw, dstyles, ddcoefs, dnoise,
    dbias), dx in x's dtype and the rest in float32; a gradient whose
    ``needs`` flag is False is None."""
    f32 = torch.float32
    s = styles.to(x.dtype)[:, :, None, None]
    sx = x * s
    # Recompute the pre-demodulation conv output u (flops for bytes).
    u = F.conv2d(sx, w.to(x.dtype), padding=1)
    ypre = u.to(f32) * dcoefs[:, :, None, None]
    if noise is not None:
        ypre = ypre + noise
    ypre = ypre + bias.to(f32)[None, :, None, None]
    gpre = g.to(f32) * _act_grad(ypre, act_gain, act_slope, clamp)
    del ypre
    dbias = gpre.sum(dim=(0, 2, 3)) if needs[5] else None
    dnoise = (gpre.sum(dim=1, keepdim=True)
              if noise is not None and needs[4] else None)
    ddcoefs = (gpre * u.to(f32)).sum(dim=(2, 3)) if needs[3] else None
    del u
    du = (gpre * dcoefs[:, :, None, None]).to(x.dtype)
    del gpre
    dx = dstyles = dw = None
    if needs[0] or needs[2]:
        # dx through the conv: the transposed conv (stride 1, pad 1).
        dsx = F.conv_transpose2d(du, w.to(x.dtype), padding=1)
        dx = dsx * s if needs[0] else None
        if needs[2]:
            dstyles = (dsx.to(f32) * x.to(f32)).sum(dim=(2, 3))
        del dsx
    if needs[1]:
        # dW[o,i,ky,kx] = sum_{n,h,w} sx[n,i,h+ky-1,w+kx-1] du[n,o,h,w], fp32.
        dw = torch.nn.grad.conv2d_weight(sx.to(f32), tuple(w.shape),
                                         du.to(f32), padding=1)
    return dx, dw, dstyles, ddcoefs, dnoise, dbias


class _FusedModconv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, styles, dcoefs, noise, bias, act_gain, act_slope,
                clamp):
        ctx.save_for_backward(x, w, styles, dcoefs, noise, bias)
        ctx.consts = (act_gain, act_slope, clamp)
        return _forward(x, w, styles, dcoefs, noise, bias, act_gain,
                        act_slope, clamp)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # Named for profiler traces (the backward's kernels are stock ones).
        with trace_scope("fused_modconv3x3_bwd"):
            grads = fused_modconv3x3_bwd(*ctx.saved_tensors, g, *ctx.consts,
                                         needs=ctx.needs_input_grad[:6])
        return grads + (None, None, None)


def fused_modconv3x3(x, w, styles, dcoefs, noise, bias,
                     act_gain=float(np.sqrt(2.0)), act_slope=LRELU_SLOPE,
                     clamp: Optional[float] = 256.0) -> torch.Tensor:
    """act(dcoef * conv3x3(styles * x, w) + noise + bias), fused.

    x [N,C_in,H,W] float32 or bfloat16; w [C_out,C_in,3,3]; styles [N,C_in];
    dcoefs [N,C_out] (ones for demodulate=False); noise [N,1,H,W] already
    scaled by noise_strength, or None; bias [C_out]; all but x float32.
    Differentiable once (the composed backward above).
    """
    return _FusedModconv3x3.apply(x, w, styles, dcoefs, noise, bias,
                                  act_gain, act_slope, clamp)


fused_modconv3x3.launches = 0      # fused levels launched since the last reset


def fused_modconv_level(x, w, styles, bias, noise=None, demodulate=True,
                        act_gain=float(np.sqrt(2.0)), act_slope=LRELU_SLOPE,
                        clamp: Optional[float] = 256.0) -> torch.Tensor:
    """Full synthesis-level forward through the fused op; the [N, C_out]
    demodulation coefficients are a small torch op outside it."""
    if demodulate:
        dcoefs = demod_coefs(w, styles)
    else:
        dcoefs = torch.ones((x.shape[0], w.shape[0]), dtype=torch.float32,
                            device=x.device)
    return fused_modconv3x3(x, w, styles, dcoefs, noise, bias,
                            act_gain, act_slope, clamp)
