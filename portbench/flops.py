"""Operations and bytes of the work the algorithms need, counted from
shapes, whatever implements them.

Operations are two per multiply-add of the convolutions, linear layers,
attention products and FIR filters; elementwise passes (bias, activation,
noise, clamps, softmax, norms) are not counted.  Bytes are each input read
once and each output written once.  The peaks are in ``harness.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

FIR_TAPS = 16          # StyleGAN2's [1, 3, 3, 1] filter, separable, 4 x 4


def channels(base: int, cmax: int, res: int) -> int:
    return min(base // res, cmax)


def mapping_flops(c: Dict[str, Any]) -> float:
    """The mapping network of one latent."""
    return 2.0 * c["mapping_layers"] * c["z_dim"] * c["w_dim"]


def synthesis_flops(c: Dict[str, Any]) -> float:
    """The synthesis network of one image: per layer the affine, the
    demodulation coefficients and the modulated convolution (an up layer
    as a stride-2 transposed 3 x 3 conv and the FIR after it), torgb, and
    the skip image's FIR upsampling."""
    base, cmax, wd = c["channel_base"], c["channel_max"], c["w_dim"]
    res_max, rgb = c["img_resolution"], c["img_channels"]
    total = 0.0
    res = 4
    while res <= res_max:
        co = channels(base, cmax, res)
        if res > 4:
            ci = channels(base, cmax, res // 2)
            total += 2.0 * wd * ci + 2.0 * 9 * ci * co          # affine, demod
            total += 2.0 * 9 * ci * co * (res // 2) ** 2         # up conv
            total += 2.0 * FIR_TAPS * co * res ** 2              # its FIR
            total += 2.0 * FIR_TAPS * rgb * res ** 2             # skip image up
        total += 2.0 * wd * co + 2.0 * 9 * co * co               # conv1
        total += 2.0 * 9 * co * co * res ** 2
        total += 2.0 * wd * co + 2.0 * co * rgb * res ** 2       # torgb
        res *= 2
    return total


def generator_flops(c: Dict[str, Any], mappings: int = 1) -> float:
    """One image of G: ``mappings`` mapping passes (2 with style mixing)
    and the synthesis network."""
    return mappings * mapping_flops(c) + synthesis_flops(c)


def discriminator_flops(c: Dict[str, Any]) -> float:
    """One image of the resnet D: fromrgb, each block's 3 x 3 conv, its
    FIR and stride-2 3 x 3 conv, its skip's FIR and stride-2 1 x 1 conv,
    and the epilogue (mbstd, conv, fc, out)."""
    base, cmax = c["channel_base"], c["channel_max"]
    res = c["img_resolution"]
    total = 2.0 * c["img_channels"] * channels(base, cmax, res) * res ** 2
    while res > 4:
        ci, co = channels(base, cmax, res), channels(base, cmax, res // 2)
        total += 2.0 * 9 * ci * ci * res ** 2
        total += 2.0 * FIR_TAPS * ci * res ** 2 + 2.0 * 9 * ci * co * (res // 2) ** 2
        total += 2.0 * FIR_TAPS * ci * (res // 2) ** 2 + 2.0 * ci * co * (res // 2) ** 2
        res //= 2
    c4 = channels(base, cmax, 4)
    total += 2.0 * 9 * (c4 + 1) * c4 * 16 + 2.0 * 16 * c4 * c4 + 2.0 * c4
    return total


def train_step_flops(c: Dict[str, Any], batch: int, g_trains_weights: bool,
                     greg: bool, dreg: bool) -> float:
    """One scheduled batch of the simultaneous Gmain+Dmain step, with the
    path-length phase (on half the batch) and the R1 phase when scheduled.

    Passes per image, in units of one forward: Gmain+Dmain runs G once
    (two mappings with mixing) and backward through its activations (1)
    and, where G's convolution weights train, their gradient (1); D runs
    once on the fake and once on the real image, and backward three times
    on the fake (to the image for G, and activations and weights for D)
    and twice on the real one.  PL: G forward, its gradient to w (1), and
    the backward of that gradient (2, plus 1 where the weights train).  R1:
    D forward, its gradient to the image (1), and the backward of that
    gradient (3).  The ADA pipe is not counted."""
    fg, fd = generator_flops(c, mappings=2), discriminator_flops(c)
    w = 1.0 if g_trains_weights else 0.0
    total = batch * (fg * (2.0 + w) + fd * 7.0)
    if greg:
        total += (batch // 2) * fg * (4.0 + w)
    if dreg:
        total += batch * fd * 5.0
    return total


def vit_flops(width: int, layers: int, patch: int, res: int,
              embed: int) -> float:
    """One image through a CLIP ViT image tower."""
    grid = (res // patch) ** 2
    tokens = grid + 1
    total = 2.0 * 3 * patch * patch * width * grid
    per_layer = (2.0 * tokens * width * 3 * width          # qkv
                 + 2.0 * 2 * tokens * tokens * width       # scores, values
                 + 2.0 * tokens * width * width            # out proj
                 + 2.0 * 2 * tokens * width * 4 * width)   # mlp
    return total + layers * per_layer + 2.0 * width * embed


def level_forward(shape: Tuple[int, int, int, int], c_out: int,
                  esize: int, noise: bool) -> Tuple[float, float]:
    """(operations, bytes) of one fused 3 x 3 level's forward: the conv's
    multiply-adds; x read and y written in their type, the weight, styles,
    coefficients, bias and noise in fp32."""
    n, ci, h, w = shape
    ops = 2.0 * n * 9 * ci * c_out * h * w
    nbytes = (n * ci * h * w * esize + n * c_out * h * w * esize
              + 4 * (c_out * ci * 9 + n * ci + n * c_out + c_out
                     + (n * h * w if noise else 0)))
    return ops, nbytes


def level_backward(shape: Tuple[int, int, int, int], c_out: int, esize: int,
                   noise: bool, weight_grad: bool) -> Tuple[float, float]:
    """(operations, bytes) of one fused level's backward as asked: the
    gradient through the conv to x (and from it the styles'), the weight's
    where it trains; x and the output gradient read, dx written, the small
    fp32 gradients written."""
    n, ci, h, w = shape
    conv = 2.0 * n * 9 * ci * c_out * h * w
    ops = conv * (2.0 if weight_grad else 1.0)
    nbytes = (2 * n * ci * h * w * esize + n * c_out * h * w * esize
              + 4 * (c_out * ci * 9 * (2 if weight_grad else 1) + 2 * n * ci
                     + 2 * n * c_out + 2 * c_out
                     + (2 * n * h * w if noise else 0)))
    return ops, nbytes


def bound_s(ops: float, nbytes: float, peak_ops: float,
            peak_bytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / peak_ops, nbytes / peak_bytes)


def level_bounds(calls: Iterable[Dict[str, Any]], peak_ops: Dict[str, float],
                 peak_bytes: float, backward: bool) -> float:
    """The summed bound of recorded level calls (``shape``, ``c_out``,
    ``dtype``, ``noise``, ``weight_grad``, ``backward``)."""
    total = 0.0
    for call in calls:
        esize = 2 if call["dtype"] == "bfloat16" else 4
        if backward:
            if not call["backward"]:
                continue
            ops, nbytes = level_backward(call["shape"], call["c_out"], esize,
                                         call["noise"], call["weight_grad"])
        else:
            ops, nbytes = level_forward(call["shape"], call["c_out"], esize,
                                        call["noise"])
        total += bound_s(ops, nbytes, peak_ops[call["dtype"]], peak_bytes)
    return total
