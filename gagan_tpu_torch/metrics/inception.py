"""InceptionV3, the FID variant (port of gagan_tpu/metrics/inception.py).

The TF-Slim InceptionV3 of inception-2015-12-05 as pytorch-fid re-expresses
it, as functions over a parameter tree keyed like pytorch-fid's state dict
(``Mixed_5b.branch1x1.conv.weight``, ``...bn.running_mean``), so the
converter copies weights 1:1.  Each convolution is followed by batch norm
folded from its running statistics (eps 1e-3) and a ReLU.  The FID
patches are kept: the in-block average pools leave the zero padding out
of the count, and Mixed_7c's pool branch takes a max pool.  The input is
resized to 299^2 by ``ops/resize.py::resize2d`` (bilinear, antialiased when
shrinking, as ``jax.image.resize``).

Outputs: the 2048-d pool features; with ``return_logits`` also the 1008-way
logits without and with the bias.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.resize import resize2d
from ..utils.checkpoint import tree_to_device

Params = Dict[str, Any]


def basic_conv2d(p: Params, x: torch.Tensor, stride=(1, 1), padding=(0, 0),
                 eps: float = 1e-3) -> torch.Tensor:
    """Conv (no bias) -> batch norm from running statistics -> ReLU."""
    x = F.conv2d(x, p["conv"]["weight"].to(x.dtype), stride=stride,
                 padding=padding)
    bn = p["bn"]
    inv = torch.rsqrt(bn["running_var"] + eps)
    x = ((x - bn["running_mean"][None, :, None, None])
         * inv[None, :, None, None])
    x = x * bn["weight"][None, :, None, None] + bn["bias"][None, :, None, None]
    return F.relu(x)


def _max_pool(x, stride=2, pad=0):
    return F.max_pool2d(x, 3, stride, pad)


def _avg_pool_exclude_pad(x):
    """3x3 average pool, stride 1, whose divisor leaves the padding out."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _inception_a(p: Params, x):
    b1 = basic_conv2d(p["branch1x1"], x)
    b5 = basic_conv2d(p["branch5x5_1"], x)
    b5 = basic_conv2d(p["branch5x5_2"], b5, padding=(2, 2))
    b3 = basic_conv2d(p["branch3x3dbl_1"], x)
    b3 = basic_conv2d(p["branch3x3dbl_2"], b3, padding=(1, 1))
    b3 = basic_conv2d(p["branch3x3dbl_3"], b3, padding=(1, 1))
    bp = basic_conv2d(p["branch_pool"], _avg_pool_exclude_pad(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p: Params, x):
    b3 = basic_conv2d(p["branch3x3"], x, stride=(2, 2))
    bd = basic_conv2d(p["branch3x3dbl_1"], x)
    bd = basic_conv2d(p["branch3x3dbl_2"], bd, padding=(1, 1))
    bd = basic_conv2d(p["branch3x3dbl_3"], bd, stride=(2, 2))
    return torch.cat([b3, bd, _max_pool(x)], dim=1)


def _inception_c(p: Params, x):
    b1 = basic_conv2d(p["branch1x1"], x)
    b7 = basic_conv2d(p["branch7x7_1"], x)
    b7 = basic_conv2d(p["branch7x7_2"], b7, padding=(0, 3))
    b7 = basic_conv2d(p["branch7x7_3"], b7, padding=(3, 0))
    bd = basic_conv2d(p["branch7x7dbl_1"], x)
    bd = basic_conv2d(p["branch7x7dbl_2"], bd, padding=(3, 0))
    bd = basic_conv2d(p["branch7x7dbl_3"], bd, padding=(0, 3))
    bd = basic_conv2d(p["branch7x7dbl_4"], bd, padding=(3, 0))
    bd = basic_conv2d(p["branch7x7dbl_5"], bd, padding=(0, 3))
    bp = basic_conv2d(p["branch_pool"], _avg_pool_exclude_pad(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p: Params, x):
    b3 = basic_conv2d(p["branch3x3_1"], x)
    b3 = basic_conv2d(p["branch3x3_2"], b3, stride=(2, 2))
    b7 = basic_conv2d(p["branch7x7x3_1"], x)
    b7 = basic_conv2d(p["branch7x7x3_2"], b7, padding=(0, 3))
    b7 = basic_conv2d(p["branch7x7x3_3"], b7, padding=(3, 0))
    b7 = basic_conv2d(p["branch7x7x3_4"], b7, stride=(2, 2))
    return torch.cat([b3, b7, _max_pool(x)], dim=1)


def _inception_e(p: Params, x, pool: str):
    b1 = basic_conv2d(p["branch1x1"], x)
    b3 = basic_conv2d(p["branch3x3_1"], x)
    b3 = torch.cat([basic_conv2d(p["branch3x3_2a"], b3, padding=(0, 1)),
                    basic_conv2d(p["branch3x3_2b"], b3, padding=(1, 0))],
                   dim=1)
    bd = basic_conv2d(p["branch3x3dbl_1"], x)
    bd = basic_conv2d(p["branch3x3dbl_2"], bd, padding=(1, 1))
    bd = torch.cat([basic_conv2d(p["branch3x3dbl_3a"], bd, padding=(0, 1)),
                    basic_conv2d(p["branch3x3dbl_3b"], bd, padding=(1, 0))],
                   dim=1)
    if pool == "avg":
        bp = _avg_pool_exclude_pad(x)
    else:  # FIDInceptionE_2: a max pool, kept for FID compatibility.
        bp = _max_pool(x, stride=1, pad=1)
    bp = basic_conv2d(p["branch_pool"], bp)
    return torch.cat([b1, b3, bd, bp], dim=1)


def inception_v3_features(params: Params, images: torch.Tensor,
                          resize_input: bool = True,
                          return_logits: bool = False):
    """images: uint8/float NCHW RGB in [0, 255] -> 2048-d features (and,
    with ``return_logits``, (features, logits, biased logits))."""
    x = images.float()
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    if resize_input and tuple(x.shape[2:]) != (299, 299):
        x = resize2d(x, (299, 299), "bilinear")
    x = x / 127.5 - 1.0

    x = basic_conv2d(params["Conv2d_1a_3x3"], x, stride=(2, 2))
    x = basic_conv2d(params["Conv2d_2a_3x3"], x)
    x = basic_conv2d(params["Conv2d_2b_3x3"], x, padding=(1, 1))
    x = _max_pool(x)
    x = basic_conv2d(params["Conv2d_3b_1x1"], x)
    x = basic_conv2d(params["Conv2d_4a_3x3"], x)
    x = _max_pool(x)

    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _inception_a(params[name], x)
    x = _inception_b(params["Mixed_6a"], x)
    for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _inception_c(params[name], x)
    x = _inception_d(params["Mixed_7a"], x)
    x = _inception_e(params["Mixed_7b"], x, pool="avg")
    x = _inception_e(params["Mixed_7c"], x, pool="max")

    features = x.mean(dim=(2, 3))
    if not return_logits:
        return features
    logits = features @ params["fc"]["weight"].T
    return features, logits, logits + params["fc"]["bias"]


# ----------------------------------------------------------------------------
# Random initialisation (real use loads a converted checkpoint).

_A_CFG = [("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64), ("Mixed_5d", 288, 64)]
_C_CFG = [("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
          ("Mixed_6e", 192)]


def init_inception_v3(gen: torch.Generator, device="cpu") -> Params:
    """Random parameters drawn on the CPU from ``gen`` (the JAX module's
    scales: convs 0.05 N(0, 1), identity batch norm, fc 0.02 N(0, 1)),
    then moved to ``device``."""
    def bc(in_ch, out_ch, kh, kw):
        return {
            "conv": {"weight": torch.randn((out_ch, in_ch, kh, kw),
                                           generator=gen) * 0.05},
            "bn": {"weight": torch.ones((out_ch,)),
                   "bias": torch.zeros((out_ch,)),
                   "running_mean": torch.zeros((out_ch,)),
                   "running_var": torch.ones((out_ch,))}}

    p: Params = {
        "Conv2d_1a_3x3": bc(3, 32, 3, 3), "Conv2d_2a_3x3": bc(32, 32, 3, 3),
        "Conv2d_2b_3x3": bc(32, 64, 3, 3), "Conv2d_3b_1x1": bc(64, 80, 1, 1),
        "Conv2d_4a_3x3": bc(80, 192, 3, 3)}
    for name, in_ch, pool_ch in _A_CFG:
        p[name] = {
            "branch1x1": bc(in_ch, 64, 1, 1),
            "branch5x5_1": bc(in_ch, 48, 1, 1),
            "branch5x5_2": bc(48, 64, 5, 5),
            "branch3x3dbl_1": bc(in_ch, 64, 1, 1),
            "branch3x3dbl_2": bc(64, 96, 3, 3),
            "branch3x3dbl_3": bc(96, 96, 3, 3),
            "branch_pool": bc(in_ch, pool_ch, 1, 1)}
    p["Mixed_6a"] = {
        "branch3x3": bc(288, 384, 3, 3),
        "branch3x3dbl_1": bc(288, 64, 1, 1),
        "branch3x3dbl_2": bc(64, 96, 3, 3),
        "branch3x3dbl_3": bc(96, 96, 3, 3)}
    for name, c7 in _C_CFG:
        p[name] = {
            "branch1x1": bc(768, 192, 1, 1),
            "branch7x7_1": bc(768, c7, 1, 1),
            "branch7x7_2": bc(c7, c7, 1, 7),
            "branch7x7_3": bc(c7, 192, 7, 1),
            "branch7x7dbl_1": bc(768, c7, 1, 1),
            "branch7x7dbl_2": bc(c7, c7, 7, 1),
            "branch7x7dbl_3": bc(c7, c7, 1, 7),
            "branch7x7dbl_4": bc(c7, c7, 7, 1),
            "branch7x7dbl_5": bc(c7, 192, 1, 7),
            "branch_pool": bc(768, 192, 1, 1)}
    p["Mixed_7a"] = {
        "branch3x3_1": bc(768, 192, 1, 1),
        "branch3x3_2": bc(192, 320, 3, 3),
        "branch7x7x3_1": bc(768, 192, 1, 1),
        "branch7x7x3_2": bc(192, 192, 1, 7),
        "branch7x7x3_3": bc(192, 192, 7, 1),
        "branch7x7x3_4": bc(192, 192, 3, 3)}
    for name, in_ch in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        p[name] = {
            "branch1x1": bc(in_ch, 320, 1, 1),
            "branch3x3_1": bc(in_ch, 384, 1, 1),
            "branch3x3_2a": bc(384, 384, 1, 3),
            "branch3x3_2b": bc(384, 384, 3, 1),
            "branch3x3dbl_1": bc(in_ch, 448, 1, 1),
            "branch3x3dbl_2": bc(448, 384, 3, 3),
            "branch3x3dbl_3a": bc(384, 384, 1, 3),
            "branch3x3dbl_3b": bc(384, 384, 3, 1),
            "branch_pool": bc(in_ch, 192, 1, 1)}
    p["fc"] = {"weight": torch.randn((1008, 2048), generator=gen) * 0.02,
               "bias": torch.zeros((1008,))}
    return tree_to_device(p, device)
