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
does: the same weights (Pillow's bicubic is Keys a = -0.5, its LANCZOS is
Lanczos-3, both with the support scaled by the shrink factor), the
horizontal pass first, each pass rounded to uint8.
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


def _lanczos3(x: np.ndarray) -> np.ndarray:
    """sinc(x) sinc(x / 3) on |x| < 3 (Pillow's LANCZOS)."""
    return np.where(np.abs(x) < 3.0, np.sinc(x) * np.sinc(x / 3.0), 0.0)


_KERNELS = {"bicubic": _keys_cubic, "cubic": _keys_cubic,
            "bilinear": _triangle, "linear": _triangle,
            "triangle": _triangle, "lanczos3": _lanczos3}


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


def resize_uint8(img: np.ndarray, out_hw: Tuple[int, int],
                 method: str = "bicubic") -> np.ndarray:
    """[H, W, C] uint8 -> [out_h, out_w, C] uint8: width first, then
    height, each pass rounded half up and clipped to [0, 255], as Pillow
    resamples 8-bit images."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    y = img.astype(np.float64)
    if w != ow:
        ww = weight_matrix(w, ow, method).astype(np.float64)
        y = np.clip(np.floor(np.tensordot(y, ww, axes=([1], [0]))
                             .transpose(0, 2, 1) + 0.5), 0, 255)
    if h != oh:
        wh = weight_matrix(h, oh, method).astype(np.float64)
        y = np.clip(np.floor(np.tensordot(wh, y, axes=([0], [0])) + 0.5),
                    0, 255)
    return y.astype(np.uint8)
