"""VGG16 features and the LPIPS embedding (port of gagan_tpu/metrics/vgg16.py).

Two uses: the 4096-d classifier features (``vgg16_features``) and the LPIPS
embedding (``vgg16_lpips``): unit-normalised conv features at the last ReLU
of each block, scaled by the square roots of the LPIPS ``lin`` weights and
spatially averaged, so that the squared L2 distance of two embeddings is the
spatial-average LPIPS distance.  Parameter names are torchvision's VGG16
state-dict keys (``features.N.weight``, ``classifier.N.weight``) plus
``lin.I.weight``, as the JAX module names them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize2d
from ..utils.checkpoint import tree_to_device

Params = Dict[str, Any]

# torchvision's VGG16 "D" configuration (M = 2x2 max pool); a conv and its
# ReLU take two indices of ``features``.
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# The LPIPS taps: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3.
LPIPS_TAPS = [2, 7, 14, 21, 28]
LPIPS_CHANNELS = [64, 128, 256, 512, 512]

_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _max_pool2(x):
    """2x2 max pool with stride 2 that drops an odd last row or column (and
    gives an empty map below 2x2, as a VALID reduce_window does)."""
    if min(x.shape[2:]) < 2:
        return x[:, :, :x.shape[2] // 2, :x.shape[3] // 2]
    return F.max_pool2d(x, 2, 2)


def _conv3x3(x, w, b):
    if x.shape[2] == 0 or x.shape[3] == 0:      # an image pooled away
        return x.new_zeros((x.shape[0], w.shape[0]) + tuple(x.shape[2:]))
    return F.conv2d(x, w.to(x.dtype), padding=1) + b[None, :, None, None]


def vgg16_backbone(params: Params, x: torch.Tensor,
                   collect_taps: bool = False
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x: float NCHW, already normalised.  Returns (final map, LPIPS taps)."""
    taps: List[torch.Tensor] = []
    idx = 0
    for v in VGG16_CFG:
        if v == "M":
            x = _max_pool2(x)
            idx += 1
        else:
            p = params["features"][str(idx)]
            x = F.relu(_conv3x3(x, p["weight"], p["bias"]))
            if collect_taps and idx in LPIPS_TAPS:
                taps.append(x)
            idx += 2
    return x, taps


def preprocess(images: torch.Tensor, size: int = 224,
               resize: bool = True) -> torch.Tensor:
    """uint8 or float NCHW RGB in [0, 255] -> ImageNet-normalised float32,
    resized to ``size``^2 (antialiased bilinear, as jax.image.resize)."""
    x = images.float() / 255.0
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    if resize and tuple(x.shape[2:]) != (size, size):
        x = resize2d(x, (size, size), "bilinear")
    mean = torch.from_numpy(_MEAN).to(x.device)[None, :, None, None]
    std = torch.from_numpy(_STD).to(x.device)[None, :, None, None]
    return (x - mean) / std


def vgg16_features(params: Params, images: torch.Tensor) -> torch.Tensor:
    """The 4096-d classifier features (fc1, ReLU, fc2, ReLU)."""
    x, _ = vgg16_backbone(params, preprocess(images))
    if x.shape[2] > 7:
        x = _max_pool2(x)
    x = x.reshape(x.shape[0], -1)
    c = params["classifier"]
    x = F.relu(x @ c["0"]["weight"].t() + c["0"]["bias"])
    return F.relu(x @ c["3"]["weight"].t() + c["3"]["bias"])


def vgg16_lpips(params: Params, images: torch.Tensor) -> torch.Tensor:
    """The LPIPS embedding [N, D] of images in [0, 255] (not resized)."""
    _, taps = vgg16_backbone(params, preprocess(images, resize=False),
                             collect_taps=True)
    outs = []
    for i, t in enumerate(taps):
        norm = t * torch.rsqrt(t.square().sum(dim=1, keepdim=True) + 1e-10)
        lin = params["lin"][str(i)]["weight"]
        weighted = norm * torch.sqrt(torch.clamp_min(lin, 0))[None, :, None,
                                                              None]
        h, w = weighted.shape[2:]
        outs.append((weighted / np.sqrt(max(h * w, 1))).flatten(1))
    return torch.cat(outs, dim=1)


def init_vgg16(gen: torch.Generator, with_lpips: bool = True,
               with_classifier: bool = True, device="cpu") -> Params:
    """Random VGG16 parameters drawn on the CPU from ``gen`` (the JAX
    module's scales), then moved to ``device``.  The classifier is drawn
    last, so leaving it out does not change the other leaves."""
    def normal(scale, *shape):
        return torch.randn(shape, generator=gen) * scale

    features: Params = {}
    idx, in_ch = 0, 3
    for v in VGG16_CFG:
        if v == "M":
            idx += 1
            continue
        features[str(idx)] = {"weight": normal(0.05, v, in_ch, 3, 3),
                              "bias": torch.zeros((v,))}
        in_ch = v
        idx += 2
    p: Params = {"features": features}
    if with_lpips:
        p["lin"] = {str(i): {"weight": normal(0.1, c).abs()}
                    for i, c in enumerate(LPIPS_CHANNELS)}
    if with_classifier:
        p["classifier"] = {
            "0": {"weight": normal(0.01, 4096, 512 * 7 * 7),
                  "bias": torch.zeros((4096,))},
            "3": {"weight": normal(0.01, 4096, 4096),
                  "bias": torch.zeros((4096,))}}
    return tree_to_device(p, device)
