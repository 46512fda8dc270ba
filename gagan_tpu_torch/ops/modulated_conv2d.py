"""Style-modulated convolution, the StyleGAN2 core op (port of
gagan_tpu/ops/modulated_conv2d.py).

Same pre/post-scaling form as the JAX module:

    y = dcoef_n,o * conv(x * style_n,i, w)           (demodulated)
    dcoef_n,o = rsqrt( sum_i style_n,i^2 * ||w_o,i||^2 + 1e-8 )

with the weight cast to ``x.dtype`` where JAX casts it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .conv2d_resample import conv2d_resample


def demod_coefs(weight: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
    """[N, O] demodulation coefficients in float32."""
    w32 = weight.float()
    s32 = styles.float()
    wsq = w32.square().sum(dim=(2, 3))                               # [O, I]
    return torch.rsqrt(torch.einsum("ni,oi->no", s32.square(), wsq) + 1e-8)


def modulated_conv2d_parts(
    x: torch.Tensor,              # [N, C_in, H, W]
    weight: torch.Tensor,         # [C_out, C_in, kh, kw]
    styles: torch.Tensor,         # [N, C_in]
    up: int = 1,
    down: int = 1,
    padding: int = 0,
    resample_filter: Optional[torch.Tensor] = None,
    demodulate: bool = True,
    flip_weight: bool = True,
    input_prenorm: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Modulate and convolve: the conv output before demodulation, and the
    [N, C_out] float32 demodulation coefficients (None without
    ``demodulate``), for a caller that applies them in its own epilogue
    (``ops/synthesis_epilogue.py``).

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
    return x, dcoefs


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
    """Modulate, convolve, demodulate, and optionally add noise
    (:func:`modulated_conv2d_parts`, then the coefficients and the noise)."""
    x, dcoefs = modulated_conv2d_parts(
        x, weight, styles, up=up, down=down, padding=padding,
        resample_filter=resample_filter, demodulate=demodulate,
        flip_weight=flip_weight, input_prenorm=input_prenorm)
    if dcoefs is not None:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
