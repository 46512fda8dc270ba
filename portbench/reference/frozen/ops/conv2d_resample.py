"""2D convolution with optional up/downsampling and FIR filtering
(port of gagan_tpu/ops/conv2d_resample.py).

Same dispatch as the JAX module: zero-insert upsample -> pad -> FIR ->
correlate with the weight -> downsample.  Where JAX runs an input-dilated
(``lhs_dilation``) convolution, torch runs the equivalent
``conv_transpose2d`` with the kernel spatially flipped and its in/out axes
swapped; ``flip_weight`` keeps its meaning (True: correlation, as
``torch.conv2d``; False: true convolution).  The convolutions are
ops/conv2d_gradfix.py's, differentiable to any order on the fast kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from . import conv2d_gradfix
from . import upfirdn2d as _updown


def _conv2d(x: torch.Tensor, w: torch.Tensor, *, stride=1, padding=(0, 0),
            groups: int = 1, flip_weight: bool = True) -> torch.Tensor:
    """Correlation (flip_weight=True) or convolution (False) over NCHW."""
    if not flip_weight:
        w = w.flip([2, 3])
    return conv2d_gradfix.conv2d(x, w.to(x.dtype), stride=stride,
                                 padding=padding, groups=groups)


def _transpose_groups(w: torch.Tensor, groups: int) -> torch.Tensor:
    """OIHW [O, I/g, kh, kw] -> conv_transpose2d layout [I, O/g, kh, kw]."""
    o, ig, kh, kw = w.shape
    w = w.reshape(groups, o // groups, ig, kh, kw).transpose(1, 2)
    return w.reshape(groups * ig, o // groups, kh, kw)


def lhs_dilated_conv2d(x: torch.Tensor, w: torch.Tensor, dilation: int,
                       padding, groups: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, lhs_dilation=(d, d), padding=P)``
    (correlation, symmetric ``padding`` = (py, px)) as a transposed conv:
    equal to ``conv_transpose2d(x, flip(w)^T, stride=d, padding=k - 1 - P)``,
    which needs ``P <= k - 1``."""
    kh, kw = w.shape[-2:]
    py, px = padding
    if py > kh - 1 or px > kw - 1:
        raise ValueError(f"padding {padding} exceeds kernel {(kh, kw)} - 1")
    wt = _transpose_groups(w.flip([2, 3]), groups).to(x.dtype)
    return conv2d_gradfix.conv_transpose2d(
        x, wt, stride=dilation, padding=(kh - 1 - py, kw - 1 - px),
        groups=groups)


def conv2d_resample(
    x: torch.Tensor,
    w: torch.Tensor,
    f: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding: Union[int, Sequence[int]] = 0,
    groups: int = 1,
    flip_weight: bool = True,
    flip_filter: bool = False,
) -> torch.Tensor:
    """2D convolution of NCHW ``x`` with OIHW ``w`` and optional resampling.

    ``padding`` is w.r.t. the upsampled image; ``f`` comes from
    :func:`gagan_tpu_torch.ops.upfirdn2d.setup_filter`.
    """
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError("conv2d_resample takes NCHW x and OIHW w")
    if not (isinstance(up, int) and up >= 1 and isinstance(down, int)
            and down >= 1):
        raise ValueError(f"up and down must be ints >= 1, got {up}, {down}")
    kh, kw = w.shape[2], w.shape[3]
    fw, fh = _updown.filter_size(f)
    px0, px1, py0, py1 = _updown.parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    # 1x1 kernel + downsampling only: downsample first, then convolve.
    if kw == 1 and kh == 1 and down > 1 and up == 1:
        x = _updown.upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1],
                              flip_filter=flip_filter)
        return _conv2d(x, w, groups=groups, flip_weight=flip_weight)

    # 1x1 kernel + upsampling only: convolve first, then upsample.
    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        return _updown.upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1],
                                 gain=up ** 2, flip_filter=flip_filter)

    # Downsampling only: FIR pre-filter, then strided convolution.
    if down > 1 and up == 1:
        x = _updown.upfirdn2d(x, f, padding=[px0, px1, py0, py1],
                              flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups,
                       flip_weight=flip_weight)

    # Upsampling: input-dilated convolution on the small input, then the
    # residual FIR/padding (the FIR commutes with the weight convolution).
    if up > 1:
        px0 -= kw - 1
        px1 -= kw - up
        py0 -= kh - 1
        py1 -= kh - up
        pxt = max(min(-px0, -px1), 0)
        pyt = max(min(-py0, -py1), 0)
        wc = w if flip_weight else w.flip([2, 3])
        x = lhs_dilated_conv2d(x, wc, up, (kh - 1 - pyt, kw - 1 - pxt),
                               groups=groups)
        x = _updown.upfirdn2d(x, f, padding=[px0 + pxt, px1 + pxt,
                                             py0 + pyt, py1 + pyt],
                              gain=up ** 2, flip_filter=flip_filter)
        if down > 1:
            x = _updown.upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    # Plain convolution with symmetric non-negative padding.
    if up == 1 and down == 1:
        if px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
            return _conv2d(x, w, padding=(py0, px0), groups=groups,
                           flip_weight=flip_weight)

    # Generic fallback.
    x = _updown.upfirdn2d(x, f if up > 1 else None, up=up,
                          padding=[px0, px1, py0, py1], gain=up ** 2,
                          flip_filter=flip_filter)
    x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
    if down > 1:
        x = _updown.upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
