"""Pad / upsample / FIR-filter / downsample for batches of NCHW images
(port of gagan_tpu/ops/upfirdn2d.py).

Each pass is zero-insert upsampling, padding (negative = crop) and one
depthwise convolution (ops/conv2d_gradfix.py) whose stride downsamples.  A separable
filter runs as a width pass then a height pass, as in the JAX module, so the
two packages sum in the same order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from . import conv2d_gradfix

Filter = Optional[torch.Tensor]


def parse_scaling(scaling: Union[int, Sequence[int]]):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling must be >= 1, got {scaling}")
    return int(sx), int(sy)


def parse_padding(padding: Union[int, Sequence[int]]):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return int(px0), int(px1), int(py0), int(py1)


def filter_size(f: Filter):
    if f is None:
        return 1, 1
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(
    f,
    normalize: bool = True,
    flip_filter: bool = False,
    gain: float = 1,
    separable: Optional[bool] = None,
    device=None,
) -> torch.Tensor:
    """Prepare a FIR filter for :func:`upfirdn2d`: float32 ``[taps]``
    (separable) or ``[fh, fw]``, normalized to unit DC gain, optionally
    flipped, scaled by ``gain ** (ndim / 2)``."""
    if f is None:
        f = 1
    f = torch.as_tensor(f, dtype=torch.float32, device=device)
    if f.ndim == 0:
        f = f[None]
    if separable is None:
        separable = f.ndim == 1 and f.numel() >= 8
    if f.ndim == 1 and not separable:
        f = torch.outer(f, f)
    if f.ndim != (1 if separable else 2):
        raise ValueError(f"filter of shape {tuple(f.shape)} does not match "
                         f"separable={separable}")
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.ndim)))
    return f * (gain ** (f.ndim / 2))


def _depthwise_pass(x: torch.Tensor, k: torch.Tensor, up=(1, 1),
                    pad=(0, 0, 0, 0), down=(1, 1)) -> torch.Tensor:
    """Per-channel correlation of ``x`` with the 2D kernel ``k`` after a
    zero-insert upsample by ``up`` (y, x) and padding ``pad``
    (x0, x1, y0, y1), keeping every ``down``-th output (y, x)."""
    n, c, h, w = x.shape
    upy, upx = up
    if upy > 1 or upx > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, h * upy, w * upx)
    x = F.pad(x, list(pad))
    k = k.to(x.dtype)[None, None].repeat(c, 1, 1, 1)
    return conv2d_gradfix.conv2d(x, k, stride=down, groups=c)


def upfirdn2d(
    x: torch.Tensor,
    f: Filter,
    up: Union[int, Sequence[int]] = 1,
    down: Union[int, Sequence[int]] = 1,
    padding: Union[int, Sequence[int]] = 0,
    flip_filter: bool = False,
    gain: float = 1,
) -> torch.Tensor:
    """Zero-insert upsample by ``up``, pad by ``padding`` = [px0, px1, py0,
    py1] (negative crops), convolve with ``f`` (true convolution unless
    ``flip_filter``), keep every ``down``-th pixel."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    upx, upy = parse_scaling(up)
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)

    if f is None:
        f = torch.ones([1, 1], dtype=torch.float32, device=x.device)
    f = f * (gain ** (f.ndim / 2))
    f = f.to(x.dtype)
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))

    if f.ndim == 1:
        x = _depthwise_pass(x, f[None, :], up=(1, upx), pad=(px0, px1, 0, 0),
                            down=(1, downx))
        return _depthwise_pass(x, f[:, None], up=(upy, 1),
                               pad=(0, 0, py0, py1), down=(downy, 1))
    return _depthwise_pass(x, f, up=(upy, upx), pad=(px0, px1, py0, py1),
                           down=(downy, downx))


def upsample2d(x: torch.Tensor, f: Filter, up: int = 2, padding: int = 0,
               flip_filter: bool = False, gain: float = 1) -> torch.Tensor:
    """Upsample by ``up`` with the FIR filter ``f``."""
    upx, upy = parse_scaling(up)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [
        px0 + (fw + upx - 1) // 2,
        px1 + (fw - upx) // 2,
        py0 + (fh + upy - 1) // 2,
        py1 + (fh - upy) // 2,
    ]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)
