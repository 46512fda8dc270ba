"""Space-to-depth ("packed") convolutions for the highest-resolution synthesis
block and the discriminator's first blocks (port of the parts of
gagan_tpu/ops/packed.py that the packed tail runs with
``packed_fused_torgb=True`` and ``packed_tail_blocks=1``, and that the
packed discriminator head runs).

The tail is reformulated exactly on a 2x2-packed grid, [N, C, H, W] ->
[N, 4C, H/2, W/2] with channel index (cell_row*2 + cell_col)*C + c:

  * stride-1 3x3 conv          -> packed 3x3 conv, 4C_in -> 4C_out;
  * up=2 3x3 conv + FIR        -> one 3x3 conv from the unpacked low-res
    input straight to the packed high-res output;
  * torgb 1x1 + depth-to-space -> one input-dilated 2x2 conv to the image;
  * FIR 2x upsample            -> grouped 3x3 conv to packed cells;
  * FIR + stride-2 3x3 / 1x1 conv (discriminator) -> one 3x3 conv from the
    packed input to the unpacked output; fromrgb 1x1 -> cell-diagonal 1x1.

The kernels are built from the ordinary weights by static index arithmetic
(see the JAX module for the derivations).
"""

from __future__ import annotations

import torch

from . import conv2d_gradfix
from .conv2d_resample import lhs_dilated_conv2d


def pack(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, 4C, H/2, W/2], cell-major channel order."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // 2, 2, w // 2, 2)
    x = x.permute(0, 3, 5, 1, 2, 4)            # [N, 2, 2, C, H/2, W/2]
    return x.reshape(n, 4 * c, h // 2, w // 2)


def unpack(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack`."""
    n, c4, hh, ww = x.shape
    c = c4 // 4
    x = x.reshape(n, 2, 2, c, hh, ww)
    x = x.permute(0, 3, 4, 1, 5, 2)            # [N, C, H/2, 2, W/2, 2]
    return x.reshape(n, c, hh * 2, ww * 2)


def pack_channel_tile(v: torch.Tensor) -> torch.Tensor:
    """Per-channel vector [.., C] -> packed [.., 4C] (cell-major)."""
    return torch.cat([v, v, v, v], dim=-1)


def _cell_tap(i: int, p: int, a_range: int, offset: int) -> dict:
    """Valid (d -> a) taps for output cell i, input cell p:
    a = 2d + offset + p - i, a in [0, a_range)."""
    taps = {}
    for d in (-2, -1, 0, 1, 2):
        a = 2 * d + offset + p - i
        if 0 <= a < a_range:
            taps[d] = a
    return taps


def build_packed_conv3x3(w: torch.Tensor) -> torch.Tensor:
    """Stride-1 3x3 correlation on the packed grid: w [O, I, 3, 3] ->
    Wp [4O, 4I, 3, 3] with conv(pack(x), Wp, pad 1) == pack(conv(x, w, pad 1))."""
    out_ch, in_ch = w.shape[0], w.shape[1]
    wp = w.new_zeros((4 * out_ch, 4 * in_ch, 3, 3))
    for i in range(2):
        for p in range(2):
            taps = _cell_tap(i, p, 3, 1)
            for j in range(2):
                for q in range(2):
                    taps_x = _cell_tap(j, q, 3, 1)
                    for dy, ay in taps.items():
                        for dx, ax in taps_x.items():
                            wp[(i * 2 + j) * out_ch:(i * 2 + j + 1) * out_ch,
                               (p * 2 + q) * in_ch:(p * 2 + q + 1) * in_ch,
                               dy + 1, dx + 1] = w[:, :, ay, ax]
    return wp


def _kernel_conv2d(a: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Full 2D convolution of per-(O,I) kernels a [O,I,ka,ka] with a small
    2D tap array k2 [kb,kb] -> [O,I,ka+kb-1,ka+kb-1]."""
    ka = a.shape[-1]
    kb = k2.shape[-1]
    out = a.new_zeros(a.shape[:2] + (ka + kb - 1, ka + kb - 1))
    for by in range(kb):
        for bx in range(kb):
            out[:, :, by:by + ka, bx:bx + ka] += a * k2[by, bx].to(a.dtype)
    return out


def build_packed_upconv(w: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Composed (up=2 conv3x3 + separable 4-tap FIR) kernel, unpacked ->
    packed: Wp [4O, I, 3, 3] with conv(x, Wp, pad 1) ==
    pack(conv2d_resample(x, w, f, up=2, padding=1, flip_weight=False))."""
    if f.ndim != 1 or f.shape[0] != 4:
        raise ValueError("4-tap separable FIR expected")
    out_ch, in_ch = w.shape[0], w.shape[1]
    f_flip = f.flip(0) * 2.0
    w_flip = w.flip([2, 3])
    g = _kernel_conv2d(w_flip, torch.outer(f_flip, f_flip))   # [O, I, 6, 6]

    wp = w.new_zeros((4 * out_ch, in_ch, 3, 3))
    for i in range(2):
        for j in range(2):
            for d in (-1, 0, 1):
                for e in (-1, 0, 1):
                    cy = 2 * d + 3 - i
                    cx = 2 * e + 3 - j
                    if 0 <= cy < 6 and 0 <= cx < 6:
                        wp[(i * 2 + j) * out_ch:(i * 2 + j + 1) * out_ch,
                           :, d + 1, e + 1] = g[:, :, cy, cx]
    return wp


def build_packed_fir_upsample(f: torch.Tensor, channels: int) -> torch.Tensor:
    """FIR 2x upsample (upsample2d, gain=4) as a grouped conv to packed
    cells: Wf [4C, 1, 3, 3], c-major (out index c*4 + cell), for groups=C."""
    if f.ndim != 1 or f.shape[0] != 4:
        raise ValueError("4-tap separable FIR expected")
    f_flip = f.flip(0) * 2.0
    cell_taps = {}
    for i in range(2):
        taps = f.new_zeros((3,))
        for d in (-1, 0, 1):
            b = 2 * d + 2 - i
            if 0 <= b < 4:
                taps[d + 1] = f_flip[b]
        cell_taps[i] = taps
    wf = f.new_zeros((4 * channels, 1, 3, 3))
    for i in range(2):
        for j in range(2):
            k2 = torch.outer(cell_taps[i], cell_taps[j])
            for c in range(channels):
                wf[c * 4 + (i * 2 + j), 0] = k2
    return wf


def conv_packed(x: torch.Tensor, wp: torch.Tensor,
                groups: int = 1) -> torch.Tensor:
    pad = (wp.shape[-1] - 1) // 2
    return conv2d_gradfix.conv2d(x, wp.to(x.dtype), padding=pad,
                                 groups=groups)


def fir_upsample_packed(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """upsample2d(img, f) producing the packed layout directly."""
    channels = img.shape[1]
    wf = build_packed_fir_upsample(f, channels)
    y = conv_packed(img, wf, groups=channels)     # [N, C*4, H', W'] c-major
    n, _, hh, ww = y.shape
    y = y.reshape(n, channels, 4, hh, ww).transpose(1, 2)
    return y.reshape(n, 4 * channels, hh, ww)


def build_torgb_transposed(w: torch.Tensor) -> torch.Tensor:
    """Packed-cell torgb 1x1 composed with depth-to-space: w [img_ch, C] ->
    K [img_ch, 4C, 2, 2] with K[c, cell(i,j)*C + ci, 1-i, 1-j] = w[c, ci]."""
    img_ch, c = w.shape
    k = w.new_zeros((img_ch, 4 * c, 2, 2))
    for i in range(2):
        for j in range(2):
            cell = i * 2 + j
            k[:, cell * c:(cell + 1) * c, 1 - i, 1 - j] = w
    return k


def conv_transposed_unpack(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Apply a :func:`build_torgb_transposed` kernel: packed [N,4C,H,W] ->
    unpacked [N, img_ch, 2H, 2W] (input dilation 2, padding 1)."""
    return lhs_dilated_conv2d(h, k, 2, (1, 1))


def _cell_slices(in_ch: int, p: int, q: int) -> slice:
    return slice((p * 2 + q) * in_ch, (p * 2 + q + 1) * in_ch)


def build_packed_downconv(w: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Composed (FIR + stride-2 3x3 conv) kernel, packed -> unpacked:
    Wp [O, 4I, 3, 3] with conv(pack(x), Wp, pad 1) ==
    conv2d_resample(x, w, f, down=2, padding=1, flip_weight=True)."""
    if f.ndim != 1 or f.shape[0] != 4:
        raise ValueError("4-tap separable FIR expected")
    out_ch, in_ch = w.shape[0], w.shape[1]
    f_flip = f.flip(0)
    g = _kernel_conv2d(w, torch.outer(f_flip, f_flip))      # [O, I, 6, 6]
    wp = w.new_zeros((out_ch, 4 * in_ch, 3, 3))
    for p in range(2):
        for q in range(2):
            for d in (-1, 0, 1):
                for e in (-1, 0, 1):
                    cy, cx = 2 * d + p + 2, 2 * e + q + 2
                    if 0 <= cy < 6 and 0 <= cx < 6:
                        wp[:, _cell_slices(in_ch, p, q), d + 1, e + 1] = \
                            g[:, :, cy, cx]
    return wp


def build_packed_down1x1(w: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Composed (FIR + down-2) kernel of a 1x1 conv (the resnet skip),
    packed -> unpacked: Wp [O, 4I, 3, 3] with conv(pack(x), Wp, pad 1) ==
    conv2d_resample(x, w, f, down=2, padding=0)."""
    if f.ndim != 1 or f.shape[0] != 4:
        raise ValueError("4-tap separable FIR expected")
    out_ch, in_ch = w.shape[0], w.shape[1]
    f_flip = f.flip(0)
    g2 = torch.outer(f_flip, f_flip).to(w.dtype)             # [4, 4]
    wp = w.new_zeros((out_ch, 4 * in_ch, 3, 3))
    w11 = w[:, :, 0, 0]
    for p in range(2):
        for q in range(2):
            for d in (-1, 0, 1):
                for e in (-1, 0, 1):
                    by, bx = 2 * d + p + 1, 2 * e + q + 1
                    if 0 <= by < 4 and 0 <= bx < 4:
                        wp[:, _cell_slices(in_ch, p, q), d + 1, e + 1] = \
                            w11 * g2[by, bx]
    return wp


def build_packed_conv1x1(w: torch.Tensor) -> torch.Tensor:
    """Cell-diagonal packed kernel of a 1x1 conv (fromrgb): w [O, I, 1, 1]
    -> Wp [4O, 4I, 1, 1]."""
    out_ch, in_ch = w.shape[0], w.shape[1]
    wp = w.new_zeros((4 * out_ch, 4 * in_ch, 1, 1))
    for cell in range(4):
        wp[cell * out_ch:(cell + 1) * out_ch,
           cell * in_ch:(cell + 1) * in_ch] = w
    return wp
