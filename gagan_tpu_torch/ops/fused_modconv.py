"""Fused modulated-conv synthesis level: the counterpart of
gagan_tpu/ops/pallas_modconv.py, with a CUDA C++ kernel for Hopper
(``csrc/fused_modconv.cu``) in place of the Pallas TPU kernel.

One op computes the stride-1 3x3 SynthesisLayer hot path,

    y = clamp(act_gain * lrelu(dcoef * conv3x3(styles * x, W) + noise + bias))

reading x once and writing y once; modulation and demodulation are folded
into the weight taps in fp32 and rounded to ``x.dtype`` (as the Pallas
kernel does), and the products accumulate in fp32.

``fused_modconv3x3`` runs the kernel on CUDA tensors and its plain PyTorch
version ``fused_modconv3x3_ref`` on CPU tensors; a CUDA tensor never takes the
plain version.  Forward only: the composed backward
(pallas_modconv.py::_bwd) comes with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .modulated_conv2d import demod_coefs

LRELU_SLOPE = 0.2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_K_CHUNK = 16      # input channels per K chunk of the kernel
_BM = 128          # output channels per block of the kernel


def supported_shape(x_shape, w_shape, up: int = 1, down: int = 1) -> bool:
    """Whether the fused kernel serves this level (else the composed path).

    Accepts every shape that the Pallas kernel's ``supported_shape`` accepts
    and more, since nothing on Hopper needs the TPU's (8, 128) tiling: W >= 128
    need not be a multiple of 128, C_in need only be a multiple of 16 (the
    kernel's K chunk), and H is free (ragged pixel tiles are masked).  C_out
    stays a multiple of 128, the kernel's channel tile, so no level pays for a
    half-empty tile, and W >= 128 keeps the kernel to the high-resolution
    levels where its per-sample tap fold is small beside the convolution.
    At FFHQ-1024 it serves b128.conv1 and b256.conv1, as the Pallas kernel does.
    """
    n, c_in, h, w = x_shape
    c_out, c_in2, kh, kw = w_shape
    return (up == 1 and down == 1 and kh == 3 and kw == 3 and c_in == c_in2
            and c_in % _K_CHUNK == 0 and c_out % _BM == 0 and w >= 128)


def fused_modconv3x3_ref(x, w, styles, dcoefs, noise, bias,
                         act_gain=float(np.sqrt(2.0)), act_slope=LRELU_SLOPE,
                         clamp: Optional[float] = 256.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel, rounding at the same places."""
    n, c_in, h, wd = x.shape
    c_out = w.shape[0]
    taps = w.float()[None] * styles.float()[:, None, :, None, None]
    taps = taps * dcoefs.float()[:, :, None, None, None]     # [N, O, I, 3, 3]
    taps = taps.to(x.dtype).float()
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
    want = {"w": (w, (c_out, c_in, 3, 3)), "styles": (styles, (n, c_in)),
            "dcoefs": (dcoefs, (n, c_out)), "bias": (bias, (c_out,))}
    if noise is not None:
        want["noise"] = (noise, (n, 1, h, wd))
    for name, (t, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _lib():
    from .. import _build

    lib = _build.load("fused_modconv")
    fn = lib.gagan_fused_modconv3x3
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, f, f, f, i, p]
        fn.restype = i
    return fn


def fused_modconv3x3(x, w, styles, dcoefs, noise, bias,
                     act_gain=float(np.sqrt(2.0)), act_slope=LRELU_SLOPE,
                     clamp: Optional[float] = 256.0) -> torch.Tensor:
    """act(dcoef * conv3x3(styles * x, w) + noise + bias), fused.

    x [N,C_in,H,W] float32 or bfloat16; w [C_out,C_in,3,3]; styles [N,C_in];
    dcoefs [N,C_out] (ones for demodulate=False); noise [N,1,H,W] already
    scaled by noise_strength, or None; bias [C_out]; all but x float32.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, styles, dcoefs, noise, bias)):
        raise NotImplementedError(
            "fused_modconv3x3 is forward-only; its backward comes with the "
            "training slice (run under torch.no_grad(), or set "
            "pallas_level=False)")
    if x.device.type == "cpu":
        return fused_modconv3x3_ref(x, w, styles, dcoefs, noise, bias,
                                    act_gain, act_slope, clamp)
    if x.device.type != "cuda":
        raise ValueError(f"fused_modconv3x3 runs on CUDA or CPU, not {x.device}")
    _check(x, w, styles, dcoefs, noise, bias)
    n, c_in, h, wd = x.shape
    c_out = w.shape[0]
    fn = _lib()
    with torch.cuda.device(x.device):
        y = torch.empty((n, c_out, h, wd), dtype=x.dtype, device=x.device)
        taps = torch.empty((n, 9, c_out, c_in), dtype=x.dtype, device=x.device)
        status = fn(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
                    styles.data_ptr(), dcoefs.data_ptr(),
                    noise.data_ptr() if noise is not None else None,
                    bias.data_ptr(), taps.data_ptr(), y.data_ptr(),
                    n, c_in, c_out, h, wd, float(act_gain), float(act_slope),
                    float(clamp) if clamp is not None else 0.0,
                    int(clamp is not None),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"fused_modconv3x3 launch failed: CUDA error {status}")
    fused_modconv3x3.launches += 1
    return y


fused_modconv3x3.launches = 0      # kernel launches since the last reset


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
