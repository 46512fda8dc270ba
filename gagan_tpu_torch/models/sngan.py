"""SN-GAN ResNet generator of the anime and MNIST auxiliary models (port
of gagan_tpu/models/sngan.py): dense -> 4x4 -> upsampling residual blocks
(BN-ReLU-up-conv3 twice, up + 1x1 shortcut) -> BN-ReLU-conv3-tanh.  Batch
norm runs on its stored statistics; spectral normalization is baked into
converted weights, as in the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..utils.checkpoint import tree_to_device

Params = Dict[str, Any]

SN_RES_GEN_CONFIGS = {
    "sn_resnet128": (1024, 1024, 512, 256, 128, 64),
    "sn_resnet64": (1024, 1024, 512, 256, 128),
    "sn_resnet32": (256, 256, 256, 256),
}


@dataclasses.dataclass(frozen=True)
class SNGANConfig:
    arch: str = "sn_resnet128"
    dim_z: int = 128
    channels: int = 3
    seed_dim: int = 4

    @property
    def ladder(self) -> Tuple[int, ...]:
        return SN_RES_GEN_CONFIGS[self.arch]

    @property
    def resolution(self) -> int:
        return self.seed_dim * 2 ** (len(self.ladder) - 1)


def _conv(x: torch.Tensor, p: Params, padding: int = 1) -> torch.Tensor:
    return F.conv2d(x, p["weight"], p.get("bias"), padding=padding)


def _bn(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.batch_norm(x, p["running_mean"], p["running_var"], p["weight"],
                        p["bias"], training=False, eps=eps)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _resblock(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(_bn(p["bn1"], x))
    h = _conv(_up2(h), p["conv1"])
    h = _conv(F.relu(_bn(p["bn2"], h)), p["conv2"])
    return h + _conv(_up2(x), p["conv_sc"], padding=0)


def sngan_apply(cfg: SNGANConfig, params: Params,
                z: torch.Tensor) -> torch.Tensor:
    """z [N, dim_z] -> image [N, channels, R, R] in [-1, 1]."""
    x = F.linear(z.float(), params["dense"]["weight"], params["dense"]["bias"])
    x = x.reshape(-1, cfg.ladder[0], cfg.seed_dim, cfg.seed_dim)
    for i in range(len(cfg.ladder) - 1):
        x = _resblock(params["blocks"][str(i)], x)
    x = F.relu(_bn(params["bn_out"], x))
    return torch.tanh(_conv(x, params["final"]))


def init_sngan(gen: torch.Generator, cfg: SNGANConfig = SNGANConfig(),
               device="cpu") -> Params:
    """Random weights (the JAX init's shapes and scale, torch draws from
    ``gen`` on the CPU), moved to ``device``."""
    def conv_p(o, i, k):
        return {"weight": torch.randn((o, i, k, k), generator=gen) * 0.05,
                "bias": torch.zeros((o,))}

    def bn_p(n):
        return {"weight": torch.ones((n,)), "bias": torch.zeros((n,)),
                "running_mean": torch.zeros((n,)),
                "running_var": torch.ones((n,))}

    ladder = cfg.ladder
    dense = ladder[0] * cfg.seed_dim ** 2
    params: Params = {
        "dense": {"weight": torch.randn((dense, cfg.dim_z), generator=gen)
                  * 0.05, "bias": torch.zeros((dense,))},
        "blocks": {str(i): {
            "bn1": bn_p(ladder[i]),
            "conv1": conv_p(ladder[i + 1], ladder[i], 3),
            "bn2": bn_p(ladder[i + 1]),
            "conv2": conv_p(ladder[i + 1], ladder[i + 1], 3),
            "conv_sc": conv_p(ladder[i + 1], ladder[i], 1),
        } for i in range(len(ladder) - 1)},
        "bn_out": bn_p(ladder[-1]),
        "final": conv_p(cfg.channels, ladder[-1], 3),
    }
    return tree_to_device(params, device)

