"""The ADA pipe's native-resolution affine warp (port of
gagan_tpu/train/warp.py).

The function is the JAX module's: a separable two-pass warp (Catmull-Smith),

    out[h, w'] = x[v(h, u), u],  u = s*w' + t*h + m,  v = p*h + q*w + r,

where each 1-D pass is a per-row fractional shift (a lerp between the two
pixels around the row's shifted origin) followed by a per-sample triangle
resample, widened to max(1, |scale|) and renormalised with ``antialias``.
The decomposition is singular near 90-degree rotations, so the transposed
variant is taken per sample.  Outside the padded window a pass reads zeros.

The JAX module spells every gather as one-hot contractions, because the
TPU's scalar core is slow at gathers.  On the GPU a gather is cheap, so
this port departs from that form: the row shift is one ``torch.gather`` of
the row's window and the resample gathers only the triangle's band (its
taps at 2*ceil(max|scale|) positions an output) instead of contracting a
dense [window, out] matrix.  The window bookkeeping of the JAX module's
hierarchical shift (a shift clipped to the padded row, block windows that
read zeros past their end) is kept as arithmetic on the per-row origins, so
the result is the same function.  Rounding follows the JAX module's dtype
use: the lerp weight and the resample weights are cast to the image's
dtype, and each stage's result is rounded to it.

Every operation is a gather, a multiply or a sum, so autograd
differentiates the warp to any order in ``images`` (R1 differentiates
D(augment(x)) twice).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils.observability import trace_scope


def _pixel_affine_from_theta(theta: torch.Tensor, in_h: int, in_w: int,
                             out_h: int, out_w: int):
    """theta [N, 2, 3] (normalized coords, affine_grid convention) ->
    pixel-space coefficients: ix = axx*ow + axy*oh + ax0 (same for iy)."""
    def coefs(row, in_dim):
        a, b, cst = theta[:, row, 0], theta[:, row, 1], theta[:, row, 2]
        cx = a * (2.0 / out_w) * (in_dim / 2.0)
        cy = b * (2.0 / out_h) * (in_dim / 2.0)
        c0 = ((a * (1.0 / out_w - 1.0) + b * (1.0 / out_h - 1.0) + cst + 1.0)
              * (in_dim / 2.0) - 0.5)
        return cx, cy, c0

    return coefs(0, in_w), coefs(1, in_h)


def _shift_geometry(d: int, out_dim: int, antialias: bool):
    """The static sizes of one JAX pass over rows of length ``d``: slack,
    window, left pad, the padded row length and the shift blocks."""
    slack = 3 if antialias else 1
    window = 2 * out_dim + 4 + 2 * slack
    pad_low = d + 1
    length = d + pad_low + (pad_low + window + 4)
    blocks = [b for b in (256, 16) if b > 1 and b * 4 <= length]
    if not blocks:
        blocks = [max(2, 1 << max(0, (length // 4).bit_length() - 1))]
    length += (-length) % blocks[0]
    return slack, window, pad_low, length, blocks


def _shift_scale_pass(data: torch.Tensor, shifts: torch.Tensor,
                      scale: torch.Tensor, out_dim: int, antialias: bool,
                      half_width: int) -> torch.Tensor:
    """data [N, C, R, D]; sample positions scale*j + shifts[n, row] for j in
    [0, out_dim); returns [N, C, R, out_dim].  ``half_width`` is
    ceil(max(1, |scale|)) over the batch (1 without ``antialias``)."""
    n, c, rows, d = data.shape
    dev, dtype = data.device, data.dtype
    slack, window, pad_low, length, blocks = _shift_geometry(
        d, out_dim, antialias)
    base = torch.clamp(scale * (out_dim - 1), max=0.0) - slack        # [N]

    # The row's shifted origin in the padded row, through the JAX module's
    # block windows: each block shift is clipped to keep its window inside
    # the one before, and the fractional remainder uses the unclipped one.
    res = torch.clamp(shifts + base[:, None] + pad_low, 0.0,
                      float(length - window - 2))
    start = torch.zeros_like(res)
    cur = length
    for b in blocks:
        k = torch.floor(res / b)
        res = res - k * b
        keep = min(-(-(window + b + 2) // b) + 1, cur // b)
        start = start + torch.clamp(k, max=float(cur // b - keep)) * b
        cur = keep * b
    k_f = torch.floor(res)
    frac = (res - k_f).to(dtype)
    origin = (start + k_f).long()                  # padded coordinate of t=0
    limit = start.long() + cur                     # the last window's end

    # Y[t] = the padded row at origin + t, t in [0, window]: zero outside
    # the data and past the last window's end.  Index 0 of ``data_z`` is the
    # zero that every such read takes.
    t = torch.arange(window + 1, device=dev)
    pos = origin[..., None] + t                                  # [N, R, T]
    src = pos - pad_low
    ok = (src >= 0) & (src < d) & (pos < limit[..., None])
    idx = torch.where(ok, src + 1, 0)
    data_z = F.pad(data, (1, 0))
    y = torch.gather(data_z, 3, idx[:, None].expand(n, c, rows, window + 1))
    # The fractional shift, its weights in the dtype, summed in float32.
    w1 = frac[:, None, :, None]
    shifted = (y[..., :-1].float() * (1.0 - w1).float()
               + y[..., 1:].float() * w1.float()).to(dtype)

    # Triangle resample at u_j = scale*j - base over the window's taps.
    j = torch.arange(out_dim, device=dev, dtype=torch.float32)
    u = scale[:, None] * j[None, :] - base[:, None]                 # [N, J]
    lo = torch.floor(u).long() - half_width + 1
    taps = [lo + m for m in range(2 * half_width)]
    width = (torch.clamp(torch.abs(scale), min=1.0)[:, None] if antialias
             else None)
    weights = []
    for tap in taps:
        dist = torch.abs(u - tap.to(torch.float32))
        wt = torch.clamp(1.0 - (dist / width if antialias else dist), min=0.0)
        weights.append(torch.where((tap >= 0) & (tap < window), wt, 0.0))
    if antialias:
        total = torch.clamp(sum(weights), min=1e-8)
        weights = [wt / total for wt in weights]
    out = None
    for tap, wt in zip(taps, weights):
        idx = torch.clamp(tap, 0, window - 1)[:, None, None, :]
        g = torch.gather(shifted, 3, idx.expand(n, c, rows, out_dim))
        term = g.float() * wt.to(dtype)[:, None, None, :]
        out = term if out is None else out + term
    return out.to(dtype)


def _warp_yx(x: torch.Tensor, coef_x, coef_y, out_h: int, out_w: int,
             half_widths: Tuple[int, int], eps: float = 1e-3,
             antialias: bool = False) -> torch.Tensor:
    """Vertical pass, then horizontal: ix = s*w' + t*h' + m;
    iy = p*h' + q*ix + r with q = ayx/axx (the caller takes the transposed
    variant where axx -> 0)."""
    n, c, in_h, in_w = x.shape
    axx, axy, ax0 = coef_x
    ayx, ayy, ay0 = coef_y
    sign = torch.where(axx >= 0, 1.0, -1.0)
    axx_safe = torch.where(torch.abs(axx) < eps, sign * eps, axx)
    q = ayx / axx_safe
    p = ayy - q * axy
    r = ay0 - q * ax0
    dev = x.device

    # Pass 1 (vertical): I1[h', w] = x[p*h' + q*w + r, w].
    xt = x.transpose(2, 3).contiguous()                      # [N, C, W, H]
    w_idx = torch.arange(in_w, dtype=torch.float32, device=dev)
    shift_v = q[:, None] * w_idx[None, :] + r[:, None]
    i1 = _shift_scale_pass(xt, shift_v, p, out_h, antialias, half_widths[0])
    i1 = i1.transpose(2, 3).contiguous()                     # [N, C, out_h, W]

    # Pass 2 (horizontal): out[h', w'] = I1[h', s*w' + t*h' + m].
    h_idx = torch.arange(out_h, dtype=torch.float32, device=dev)
    shift_u = axy[:, None] * h_idx[None, :] + ax0[:, None]
    return _shift_scale_pass(i1, shift_u, axx, out_w, antialias,
                             half_widths[1])


def _half_widths(coef_x, coef_y, antialias: bool, eps: float = 1e-3):
    """ceil(max(1, |scale|)) over the batch for both passes: one host read."""
    if not antialias:
        return 1, 1
    axx, axy, _ = coef_x
    ayx, ayy, _ = coef_y
    sign = torch.where(axx >= 0, 1.0, -1.0)
    axx_safe = torch.where(torch.abs(axx) < eps, sign * eps, axx)
    p = ayy - ayx / axx_safe * axy
    hw = torch.stack([torch.abs(p).amax(), torch.abs(axx).amax()])
    with trace_scope("host_read.warp"):
        hw = hw.tolist()
    return tuple(max(1, math.ceil(v)) for v in hw)


def affine_warp(images: torch.Tensor, theta: torch.Tensor, out_h: int,
                out_w: int, antialias: bool = False) -> torch.Tensor:
    """Warp images [N, C, H, W] by theta [N, 2, 3] (normalized coordinates,
    the ``affine_grid`` convention) to [N, C, out_h, out_w].

    Each sample takes the normal or the transposed two-pass variant,
    whichever diagonal of its transform dominates.  With ``antialias`` each
    pass's triangle widens to max(1, |scale|) and is renormalised (area
    weighting when minifying).  Differentiable to any order in images."""
    n, c, in_h, in_w = images.shape
    theta = theta.to(torch.float32)
    coef_x, coef_y = _pixel_affine_from_theta(theta, in_h, in_w, out_h, out_w)
    axx, axy, ax0 = coef_x
    ayx, ayy, ay0 = coef_y
    use_a = torch.abs(axx * ayy) >= torch.abs(axy * ayx)

    if in_h == in_w:
        # Square input: the transposed variant is the same warp of x^T with
        # the coefficients' roles swapped, so one warp serves both.
        x_sel = torch.where(use_a[:, None, None, None], images,
                            images.transpose(2, 3))

        def sel(a, b):
            return torch.where(use_a, a, b)

        coef1 = (sel(axx, ayx), sel(axy, ayy), sel(ax0, ay0))
        coef2 = (sel(ayx, axx), sel(ayy, axy), sel(ay0, ax0))
        hw = _half_widths(coef1, coef2, antialias)
        return _warp_yx(x_sel, coef1, coef2, out_h, out_w, hw,
                        antialias=antialias)

    # Rectangular input: both variants, then the per-sample choice.
    hw_a = _half_widths(coef_x, coef_y, antialias)
    hw_b = _half_widths(coef_y, coef_x, antialias)
    out_a = _warp_yx(images, coef_x, coef_y, out_h, out_w, hw_a,
                     antialias=antialias)
    out_b = _warp_yx(images.transpose(2, 3), coef_y, coef_x, out_h, out_w,
                     hw_b, antialias=antialias)
    return torch.where(use_a[:, None, None, None], out_a, out_b)
