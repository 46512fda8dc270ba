"""Image utilities: differentiable bicubic downsampling, tensor -> uint8
conversion, and the paper's 16-image grid (port of
gagan_tpu/utils/image_utils.py).

The resizes follow the JAX package's ``jax.image.resize``: its "nearest"
takes half-pixel centres, which is ``F.interpolate``'s "nearest-exact"
(plain "nearest" picks the other pixel at an exact /2 or /4), and its
"bilinear" antialiases when it shrinks, which is ``F.interpolate``'s
bilinear with ``antialias=True``.  The reference resizes with
``F.interpolate``'s default "nearest"; the JAX package departs from it
there, and the port follows the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _bicubic_kernel_1d(factor: int, a: float = -0.5) -> np.ndarray:
    """4*factor-tap normalized bicubic kernel."""
    size = factor * 4
    x = (np.arange(size) - np.floor(size / 2) + 0.5) / factor
    ax = np.abs(x)
    k = np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a,
                 0.0),
    ).astype(np.float32)
    return k / k.sum()


def bicubic_downsample(x: torch.Tensor, factor: int = 4,
                       clip_round: bool = False) -> torch.Tensor:
    """Anti-aliased bicubic downsample of NCHW ``x`` by an integer
    ``factor``: reflect padding of ``3 * factor`` split floor / ceil, then a
    vertical and a horizontal depthwise pass of the 4*factor-tap kernel with
    stride ``factor``.  Differentiable."""
    c = x.shape[1]
    k = torch.as_tensor(_bicubic_kernel_1d(factor), dtype=x.dtype,
                        device=x.device)
    pad = factor * 4 - factor
    lo, hi = pad // 2, pad - pad // 2
    y = F.conv2d(F.pad(x, (0, 0, lo, hi), mode="reflect"),
                 k.view(1, 1, -1, 1).expand(c, 1, -1, 1), stride=(factor, 1),
                 groups=c)
    if clip_round:
        y = y.round().clamp(0.0, 255.0)
    y = F.conv2d(F.pad(y, (lo, hi, 0, 0), mode="reflect"),
                 k.view(1, 1, 1, -1).expand(c, 1, 1, -1), stride=(1, factor),
                 groups=c)
    if clip_round:
        y = y.round().clamp(0.0, 255.0)
    return y


def resize_img(img: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest-neighbour square resize of one CHW image (half-pixel
    centres, as ``jax.image.resize``)."""
    return F.interpolate(img[None], size=(size, size), mode="nearest-exact")[0]


def _resize_smaller_edge(img: torch.Tensor, size: int) -> torch.Tensor:
    """torchvision ``Resize(size)``: scale so the smaller edge is ``size``,
    bilinear, antialiased when shrinking."""
    c, h, w = img.shape
    if h <= w:
        new_h, new_w = size, max(1, round(w * size / h))
    else:
        new_h, new_w = max(1, round(h * size / w)), size
    return F.interpolate(img[None], size=(new_h, new_w), mode="bilinear",
                         align_corners=False, antialias=True)[0]


def _to_uint8(img: torch.Tensor) -> np.ndarray:
    arr = img.permute(1, 2, 0).detach().cpu().numpy()
    return np.round((np.clip(arr, -1, 1) + 1) / 2 * 255).astype(np.uint8)


def t2im(img: torch.Tensor, size: int = 512) -> np.ndarray:
    """[-1, 1] CHW float image -> HWC uint8, smaller edge resized to
    ``size``."""
    return _to_uint8(_resize_smaller_edge(img.float(), size))


def construct_paper_image_grid(img: torch.Tensor) -> np.ndarray:
    """The paper's 16-image figure from NCHW images in [-1, 1]: two
    full-size images, then 2x3 half-size, then 4x2 quarter-size columns;
    height 512; HWC uint8."""
    if img.shape[0] < 16:
        raise ValueError("paper grid needs a batch of 16 images")
    img = img.float()
    full = img.shape[-1]
    half, quarter = full // 2, full // 4
    base = torch.cat([img[0], img[1]], dim=2)
    sub = [torch.cat([resize_img(img[i + j], half) for j in range(2)], dim=1)
           for i in range(2, 8, 2)]
    base = torch.cat([base, *sub], dim=2)
    sub = [torch.cat([resize_img(img[i + j], quarter) for j in range(4)],
                     dim=1) for i in range(8, 16, 4)]
    base = torch.cat([base, *sub], dim=2)
    return _to_uint8(_resize_smaller_edge(base, 512))


def crop_augmentation(image: torch.Tensor, size: int = 1024,
                      alpha: float = 0.8, rng=None,
                      offsets: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Random alpha-crop of the last two axes: an ``int(size * alpha)``
    square whose offsets (rows, columns) are ``offsets`` where given, else
    two draws in [0, ``int(size * (1 - alpha))``) from ``rng`` (a
    ``torch.Generator`` or a draw source with ``randint``, such as
    :class:`~gagan_tpu_torch.utils.rng.Rng`).  Starts past the last whole
    square are clamped, as ``lax.dynamic_slice`` clamps them."""
    max_ = int(size * (1 - alpha))
    len_ = int(size * alpha)
    if offsets is None:
        if isinstance(rng, torch.Generator):
            drawn = torch.randint(0, max_, (2,), generator=rng)
        else:
            drawn = rng.randint((2,), 0, max_)
        offsets = [int(v) for v in drawn]
    x = min(max(int(offsets[0]), 0), image.shape[-2] - len_)
    y = min(max(int(offsets[1]), 0), image.shape[-1] - len_)
    return image[..., x:x + len_, y:y + len_]
