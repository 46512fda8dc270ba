"""BigGAN class-conditional generator (port of gagan_tpu/models/biggan.py):
a shared class embedding, hierarchical z chunks, GBlocks with
class-conditional batch norm, self-attention at one resolution, and
BN-ReLU-conv-tanh out.  Batch norm runs on its stored statistics and
spectral normalization is baked into converted weights, so every conv is
a plain convolution.  The parameter tree is the JAX package's, so one npz
loads in both."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..utils.checkpoint import tree_to_device

Params = Dict[str, Any]


def g_arch(ch: int, resolution: int, attention: int = 64):
    """Channels, resolution and attention flag of each GBlock."""
    table = {
        512: ([16, 16, 8, 8, 4, 2, 1], [16, 8, 8, 4, 2, 1, 1]),
        256: ([16, 16, 8, 8, 4, 2], [16, 8, 8, 4, 2, 1]),
        128: ([16, 16, 8, 4, 2], [16, 8, 4, 2, 1]),
        64: ([16, 16, 8, 4], [16, 8, 4, 2]),
        32: ([4, 4, 4], [4, 4, 4]),
    }
    ins, outs = table[resolution]
    res_per_block = [2 ** (i + 3) for i in range(len(ins))]
    return {
        "in_channels": [ch * c for c in ins],
        "out_channels": [ch * c for c in outs],
        "resolution": res_per_block,
        "attention": {r: r == attention for r in res_per_block},
    }


@dataclasses.dataclass(frozen=True)
class BigGANConfig:
    ch: int = 64
    dim_z: int = 120
    bottom_width: int = 4
    resolution: int = 128
    n_classes: int = 1000
    shared_dim: int = 128
    hier: bool = True
    attention: int = 64

    @property
    def arch(self):
        return g_arch(self.ch, self.resolution, self.attention)

    @property
    def num_slots(self) -> int:
        return len(self.arch["in_channels"]) + 1 if self.hier else 1

    @property
    def z_chunk_size(self) -> int:
        return self.dim_z // self.num_slots if self.hier else 0


def _conv(x: torch.Tensor, p: Params, padding: int = 1) -> torch.Tensor:
    return F.conv2d(x, p["weight"], p.get("bias"), padding=padding)


def _ccbn(p: Params, x: torch.Tensor, y: torch.Tensor,
          eps: float = 1e-5) -> torch.Tensor:
    """Class-conditional batch norm on stored statistics."""
    gain = 1.0 + y @ p["gain"]["weight"].T
    bias = y @ p["bias"]["weight"].T
    xn = F.batch_norm(x, p["stored_mean"], p["stored_var"], training=False,
                      eps=eps)
    return xn * gain[:, :, None, None] + bias[:, :, None, None]


def _bn(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.batch_norm(x, p["stored_mean"], p["stored_var"], p["gain"],
                        p["bias"], training=False, eps=eps)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _gblock(p: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    h = _up2(F.relu(_ccbn(p["bn1"], x, y)))
    h = _conv(h, p["conv1"])
    h = _conv(F.relu(_ccbn(p["bn2"], h, y)), p["conv2"])
    return h + _conv(_up2(x), p["conv_sc"], padding=0)


def _attention(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Self-attention: queries at every pixel, keys and values 2x2
    max-pooled."""
    n, c, h, w = x.shape
    theta = _conv(x, p["theta"], padding=0).reshape(n, c // 8, h * w)
    phi = F.max_pool2d(_conv(x, p["phi"], padding=0), 2).reshape(
        n, c // 8, h * w // 4)
    g = F.max_pool2d(_conv(x, p["g"], padding=0), 2).reshape(
        n, c // 2, h * w // 4)
    beta = torch.softmax(theta.transpose(1, 2) @ phi, dim=-1)   # [n, t, s]
    o = (g @ beta.transpose(1, 2)).reshape(n, c // 2, h, w)
    return p["gamma"] * _conv(o, p["o"], padding=0) + x


def biggan_apply(cfg: BigGANConfig, params: Params, z: torch.Tensor,
                 class_ids: torch.Tensor) -> torch.Tensor:
    """z [N, dim_z], class ids [N] -> image [N, 3, R, R] in [-1, 1]."""
    z = z.float()
    y = params["shared"]["weight"][class_ids.long()]         # [N, shared_dim]
    arch = cfg.arch
    if cfg.hier:
        chunks = torch.split(z[:, :cfg.z_chunk_size * cfg.num_slots],
                             cfg.z_chunk_size, dim=1)
        z0 = chunks[0]
        ys = [torch.cat([y, c], dim=1) for c in chunks[1:]]
    else:
        z0 = z
        ys = [y] * len(arch["in_channels"])
    h = F.linear(z0, params["linear"]["weight"], params["linear"]["bias"])
    h = h.reshape(-1, arch["in_channels"][0], cfg.bottom_width,
                  cfg.bottom_width)
    for i, res in enumerate(arch["resolution"]):
        block = params["blocks"][str(i)]
        h = _gblock(block["0"], h, ys[i])
        if arch["attention"][res]:
            h = _attention(block["1"], h)
    out = params["output_layer"]
    h = _conv(F.relu(_bn(out["0"], h)), out["2"])
    return torch.tanh(h)


def init_biggan(gen: torch.Generator, cfg: BigGANConfig = BigGANConfig(),
                device="cpu") -> Params:
    """Random weights (the JAX init's shapes and scale, torch draws from
    ``gen`` on the CPU), moved to ``device``."""
    def normal(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    def conv_p(o, i, k, bias=True):
        p = {"weight": normal(o, i, k, k)}
        if bias:
            p["bias"] = torch.zeros((o,))
        return p

    def lin_p(o, i, bias=True):
        p = {"weight": normal(o, i)}
        if bias:
            p["bias"] = torch.zeros((o,))
        return p

    def ccbn_p(n):
        return {"gain": lin_p(n, cond_dim, bias=False),
                "bias": lin_p(n, cond_dim, bias=False),
                "stored_mean": torch.zeros((n,)),
                "stored_var": torch.ones((n,))}

    cond_dim = cfg.shared_dim + cfg.z_chunk_size
    arch = cfg.arch
    params: Params = {
        "shared": {"weight": normal(cfg.n_classes, cfg.shared_dim)},
        "linear": lin_p(arch["in_channels"][0] * cfg.bottom_width ** 2,
                        cfg.z_chunk_size if cfg.hier else cfg.dim_z),
        "blocks": {},
    }
    for i, res in enumerate(arch["resolution"]):
        ci, co = arch["in_channels"][i], arch["out_channels"][i]
        block: Params = {"0": {
            "bn1": ccbn_p(ci), "conv1": conv_p(co, ci, 3),
            "bn2": ccbn_p(co), "conv2": conv_p(co, co, 3),
            "conv_sc": conv_p(co, ci, 1),
        }}
        if arch["attention"][res]:
            block["1"] = {
                "theta": conv_p(co // 8, co, 1, bias=False),
                "phi": conv_p(co // 8, co, 1, bias=False),
                "g": conv_p(co // 2, co, 1, bias=False),
                "o": conv_p(co, co // 2, 1, bias=False),
                "gamma": torch.zeros(()),
            }
        params["blocks"][str(i)] = block
    ch_last = arch["out_channels"][-1]
    params["output_layer"] = {
        "0": {"gain": torch.ones((ch_last,)), "bias": torch.zeros((ch_last,)),
              "stored_mean": torch.zeros((ch_last,)),
              "stored_var": torch.ones((ch_last,))},
        "2": conv_p(3, ch_last, 3),
    }
    return tree_to_device(params, device)
