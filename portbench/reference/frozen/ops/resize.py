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
