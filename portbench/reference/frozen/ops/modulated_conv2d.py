"""Style-modulated convolution, the StyleGAN2 core op (port of
gagan_tpu/ops/modulated_conv2d.py).

Same pre/post-scaling form as the JAX module:

    y = dcoef_n,o * conv(x * style_n,i, w)           (demodulated)
    dcoef_n,o = rsqrt( sum_i style_n,i^2 * ||w_o,i||^2 + 1e-8 )

with the weight cast to ``x.dtype`` where JAX casts it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .conv2d_resample import conv2d_resample


def demod_coefs(weight: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
    """[N, O] demodulation coefficients in float32."""
    w32 = weight.float()
    s32 = styles.float()
    wsq = w32.square().sum(dim=(2, 3))                               # [O, I]
    return torch.rsqrt(torch.einsum("ni,oi->no", s32.square(), wsq) + 1e-8)


def modulated_conv2d(
    x: torch.Tensor,              # [N, C_in, H, W]
    weight: torch.Tensor,         # [C_out, C_in, kh, kw]
    styles: torch.Tensor,         # [N, C_in]
    noise: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding: int = 0,
    resample_filter: Optional[torch.Tensor] = None,
    demodulate: bool = True,
    flip_weight: bool = True,
    input_prenorm: bool = False,
) -> torch.Tensor:
    """Modulate, convolve, demodulate, and optionally add noise.

    ``input_prenorm`` is the reference's fp16 overflow guard: the weight is
    normalized per output channel by its inf-norm, the styles per sample.
    """
    batch_size = x.shape[0]
    out_channels, in_channels, kh, kw = weight.shape
    if tuple(styles.shape) != (batch_size, in_channels):
        raise ValueError(f"styles of shape {tuple(styles.shape)} do not fit "
                         f"x {tuple(x.shape)} and weight {tuple(weight.shape)}")

    if input_prenorm and demodulate:
        norm = weight.abs().amax(dim=(1, 2, 3), keepdim=True)
        weight = weight * (1.0 / (in_channels * kh * kw) ** 0.5 / norm)
        styles = styles / styles.abs().amax(dim=1, keepdim=True)

    dcoefs = demod_coefs(weight, styles) if demodulate else None

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up,
                        down=down, padding=padding, flip_weight=flip_weight)

    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
