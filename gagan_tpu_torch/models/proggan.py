"""Progressive-growing GAN generator at 1024^2 (port of
gagan_tpu/models/proggan.py).

PixelNorm, (2x nearest upsample,) conv, WScale and leaky ReLU over the 18
feature blocks of :data:`BLOCKS`, then a 1x1 RGB output.  Parameter keys
follow the JAX tree (``features.N.conv.weight``, ``features.N.wscale.{scale,
b}``, ``output.conv.weight``, ``output.wscale.*``), so one npz loads in
both packages.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..utils.checkpoint import tree_to_device

Params = Dict[str, Any]

# (upscale, in, out, kernel, padding) per block.
BLOCKS = [
    (False, 512, 512, 4, 3), (False, 512, 512, 3, 1),
    (True, 512, 512, 3, 1), (False, 512, 512, 3, 1),
    (True, 512, 512, 3, 1), (False, 512, 512, 3, 1),
    (True, 512, 512, 3, 1), (False, 512, 512, 3, 1),
    (True, 512, 256, 3, 1), (False, 256, 256, 3, 1),
    (True, 256, 128, 3, 1), (False, 128, 128, 3, 1),
    (True, 128, 64, 3, 1), (False, 64, 64, 3, 1),
    (True, 64, 32, 3, 1), (False, 32, 32, 3, 1),
    (True, 32, 16, 3, 1), (False, 16, 16, 3, 1),
]
Z_DIM = 512


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + eps)


def _wscale(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x * p["scale"] + p["b"][None, :, None, None]


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def proggan_apply(params: Params, z: torch.Tensor) -> torch.Tensor:
    """z [N, 512] or [N, 512, 1, 1] -> image [N, 3, 1024, 1024]."""
    x = z.reshape(z.shape[0], Z_DIM, 1, 1).float()
    for i, (up, _ci, _co, _k, pad) in enumerate(BLOCKS):
        p = params["features"][str(i)]
        x = pixel_norm(x)
        if up:
            x = _upsample2(x)
        x = F.conv2d(x, p["conv"]["weight"], padding=pad)
        x = F.leaky_relu(_wscale(p["wscale"], x), 0.2)
    p = params["output"]
    x = F.conv2d(pixel_norm(x), p["conv"]["weight"])
    return _wscale(p["wscale"], x)


def init_proggan(gen: torch.Generator, device="cpu") -> Params:
    """Random weights (the JAX init's shapes and scale, torch draws from
    ``gen`` on the CPU), moved to ``device``."""
    def conv(co, ci, k):
        return {"conv": {"weight": torch.randn((co, ci, k, k),
                                               generator=gen) * 0.05},
                "wscale": {"scale": torch.ones((1,)),
                           "b": torch.zeros((co,))}}

    params: Params = {"features": {
        str(i): conv(co, ci, k) for i, (_up, ci, co, k, _pad)
        in enumerate(BLOCKS)}}
    params["output"] = conv(3, BLOCKS[-1][2], 1)
    return tree_to_device(params, device)

