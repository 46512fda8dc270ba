"""Separable image resize as two constant-weight matmuls (port of
gagan_tpu/ops/resize.py).

``weight_matrix`` is the JAX module's numpy port of ``jax.image``'s
``compute_weight_mat`` (Keys cubic a = -0.5, or triangle; antialiased when
shrinking), so ``resize2d`` in float32 matches ``jax.image.resize``.  The
adaptation step resizes the 1024^2 generator output to CLIP's 224^2 inside
the differentiated loss; the backward of a matmul by a constant is the
transposed matmul.  The matmuls run in the input's dtype: fp32 (full
precision unless TF32 is switched on for matmuls) or bf16, as the JAX
module runs them at ``precision='highest'`` or at the default.

``resize_uint8`` resizes a uint8 image on the host as Pillow's ``resize``
does, pixel for pixel: Pillow's own coefficient loop and filters (BOX,
BILINEAR, BICUBIC with a = -0.5, LANCZOS-3, the support scaled by the
shrink factor), its 22-bit fixed-point weights, the horizontal pass first,
each pass rounded to uint8 as Pillow rounds.  ``resize_uint8_tensor`` does
the same on a tensor's device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys (1981) cubic convolution kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"bicubic": _keys_cubic, "cubic": _keys_cubic,
            "bilinear": _triangle, "linear": _triangle,
            "triangle": _triangle}


@functools.lru_cache(maxsize=64)
def weight_matrix(src: int, dst: int, method: str = "bicubic",
                  antialias: bool = True) -> np.ndarray:
    """[src, dst] float32 resampling matrix, the one ``jax.image.resize``
    builds (scale dst/src, no translation)."""
    kernel = _KERNELS[method]
    inv_scale = src / dst
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (np.arange(dst, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :]
               - np.arange(src, dtype=np.float64)[:, None]) / kernel_scale
    weights = kernel(x)
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0.0)
    weights = np.where(
        np.logical_and(sample_f >= -0.5, sample_f <= src - 0.5)[None, :],
        weights, 0.0)
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _weight_tensor(src: int, dst: int, method: str, antialias: bool,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """weight_matrix on ``device`` in ``dtype``, made once per shape."""
    return torch.from_numpy(weight_matrix(src, dst, method, antialias)).to(
        device=device, dtype=dtype)


def resize2d(x: torch.Tensor, out_hw: Tuple[int, int],
             method: str = "bicubic", antialias: bool = True) -> torch.Tensor:
    """[..., H, W] -> [..., out_h, out_w] by two matmuls with constant
    weights, in x's dtype; an axis already at its size is left alone."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = out_hw
    y = x
    if h != oh:
        wh = _weight_tensor(h, oh, method, antialias, y.dtype, y.device)
        y = torch.matmul(wh.t(), y)                      # [..., oh, W]
    if w != ow:
        ww = _weight_tensor(w, ow, method, antialias, y.dtype, y.device)
        y = torch.matmul(y, ww)                          # [..., oh, ow]
    return y


def _pil_box(x):
    return ((x > -0.5) & (x <= 0.5)).astype(np.float64)


def _pil_bicubic(x, a=-0.5):
    """Keys' cubic in Pillow's order of evaluation (the rounded integer
    coefficients depend on the last bits)."""
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_lanczos(x):
    return np.where((x >= -3.0) & (x < 3.0), np.sinc(x) * np.sinc(x / 3.0),
                    0.0)


# Pillow's resampling filters: (support, filter).
_PIL_FILTERS = {"box": (0.5, _pil_box), "bilinear": (1.0, _triangle),
                "bicubic": (2.0, _pil_bicubic), "lanczos3": (3.0, _pil_lanczos)}
_PRECISION_BITS = 22            # Pillow's fixed point for 8-bit images


@functools.lru_cache(maxsize=64)
def pillow_matrix(src: int, dst: int, method: str) -> np.ndarray:
    """[src, dst] float64 matrix of Pillow's integer coefficients for an
    8-bit resize: its coefficient loop (support scaled by the shrink
    factor, taps from int(center - support + 0.5), each output's weights
    normalised), then each weight scaled by 2^22 and rounded away from
    zero, as Pillow's ``normalize_coeffs_8bpc``."""
    support, kernel = _PIL_FILTERS[method]
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = support * filterscale
    out = np.zeros((src, dst))
    for xx in range(dst):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src)
        w = kernel((np.arange(xmin, xmax) - center + 0.5) / filterscale)
        total = w.sum()
        if total != 0.0:
            w = w / total
        out[xmin:xmax, xx] = w
    return np.trunc(out * (1 << _PRECISION_BITS) + np.where(out < 0, -0.5,
                                                             0.5))


def resize_uint8_tensor(img: torch.Tensor, out_hw: Tuple[int, int],
                        method: str = "bicubic") -> torch.Tensor:
    """A uint8 [H, W, C] tensor resized on its device as Pillow's
    ``resize``: width first, then height, each pass an integer sum of
    Pillow's fixed-point coefficients, in float64 (every partial sum is an
    integer below 2^53, so any summation order gives Pillow's pixels),
    rounded and clipped to uint8 as Pillow does."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    dev = img.device
    half, one = 1 << (_PRECISION_BITS - 1), 1 << _PRECISION_BITS
    y = img.double()
    if w != ow:
        ww = torch.from_numpy(pillow_matrix(w, ow, method)).to(dev)
        y = torch.matmul(y.transpose(1, 2), ww).transpose(1, 2)
        y = torch.floor((y + half) / one).clamp(0, 255)
    if h != oh:
        wh = torch.from_numpy(pillow_matrix(h, oh, method)).to(dev)
        c = y.shape[2]
        y = torch.matmul(wh.t(), y.reshape(h, -1)).reshape(oh, ow, c)
        y = torch.floor((y + half) / one).clamp(0, 255)
    return y.to(torch.uint8)


def resize_uint8(img: np.ndarray, out_hw: Tuple[int, int],
                 method: str = "bicubic") -> np.ndarray:
    """[H, W, C] uint8 -> [out_h, out_w, C] uint8 as Pillow's ``resize``
    with BOX ("box"), BILINEAR, BICUBIC or LANCZOS ("lanczos3"), on the
    host: :func:`resize_uint8_tensor` on the CPU."""
    return resize_uint8_tensor(torch.from_numpy(np.ascontiguousarray(img)),
                               out_hw, method).numpy()
