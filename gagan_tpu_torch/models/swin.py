"""Swin Transformer feature backbone, Swin-T by default (port of
gagan_tpu/models/swin.py).

The GA's feature extractor is torchvision's ``swin_t().features``; this
module computes HuggingFace ``SwinModel``'s encoder (the same paper math),
so ImageNet weights convert from ``microsoft/swin-tiny-patch4-window7-224``
with ``params_from_hf``.  Per stage, the window is ``min(7, H, W)``; the
token grid is padded at the bottom and right to a multiple of it; odd
blocks shift by half a window (``torch.roll``) when ``min(H, W)`` exceeds
the window, with an additive -100 mask across the regions of the padded
grid; the relative-position bias indexes a (2ws - 1)^2 table.  Attention
is a matmul, a softmax and a matmul per window.  The MLP's GELU is exact.
Patch merging pads odd sizes and concatenates x0, x1, x2, x3 before its
LayerNorm and bias-free linear layer.  The input is not resized.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.checkpoint import tree_to_device

Params = Dict

LN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    image_size: int = 224
    patch_size: int = 4
    num_channels: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0


def swin_tiny_config() -> SwinConfig:
    return SwinConfig()


# ----------------------------------------------------------------------------
# Parameters


def init_swin(gen: torch.Generator, cfg: SwinConfig, device="cpu") -> Params:
    """Random parameters drawn on the CPU from ``gen`` (the JAX module's
    scales: linear and patch weights 0.02 N(0, 1), zero biases and
    relative-position tables, unit LayerNorms), then moved to ``device``.
    ``layers`` and ``blocks`` are lists, as in the JAX tree."""
    def linear(din, dout, bias=True):
        p = {"weight": (torch.randn((dout, din), generator=gen) * 0.02)}
        if bias:
            p["bias"] = torch.zeros((dout,))
        return p

    def ln(dim):
        return {"weight": torch.ones((dim,)), "bias": torch.zeros((dim,))}

    params: Params = {
        "patch_embed": {
            "proj": {"weight": torch.randn(
                (cfg.embed_dim, cfg.num_channels, cfg.patch_size,
                 cfg.patch_size), generator=gen) * 0.02,
                "bias": torch.zeros((cfg.embed_dim,))},
            "norm": ln(cfg.embed_dim)},
        "layers": []}
    table = (2 * cfg.window_size - 1) ** 2
    for i, depth in enumerate(cfg.depths):
        dim = cfg.embed_dim * 2 ** i
        hidden = int(dim * cfg.mlp_ratio)
        layer = {"blocks": [{
            "norm1": ln(dim), "q": linear(dim, dim), "k": linear(dim, dim),
            "v": linear(dim, dim), "proj": linear(dim, dim),
            "rel_bias": torch.zeros((table, cfg.num_heads[i])),
            "norm2": ln(dim), "fc1": linear(dim, hidden),
            "fc2": linear(hidden, dim)} for _ in range(depth)]}
        if i < len(cfg.depths) - 1:
            layer["downsample"] = {"norm": ln(4 * dim),
                                   "reduction": linear(4 * dim, 2 * dim,
                                                       bias=False)}
        params["layers"].append(layer)
    return tree_to_device(params, device)


def params_from_hf(state_dict: Dict, cfg: SwinConfig, device="cpu") -> Params:
    """A HuggingFace SwinModel state dict (numpy arrays or tensors) -> the
    parameter tree on ``device``."""
    def g(name):
        return torch.as_tensor(np.asarray(state_dict[name]), device=device)

    def lin(prefix, bias=True):
        p = {"weight": g(prefix + ".weight")}
        if bias:
            p["bias"] = g(prefix + ".bias")
        return p

    params: Params = {
        "patch_embed": {
            "proj": lin("embeddings.patch_embeddings.projection"),
            "norm": lin("embeddings.norm")},
        "layers": []}
    for i, depth in enumerate(cfg.depths):
        layer = {"blocks": []}
        for b in range(depth):
            pre = f"encoder.layers.{i}.blocks.{b}"
            att = f"{pre}.attention"
            layer["blocks"].append({
                "norm1": lin(f"{pre}.layernorm_before"),
                "q": lin(f"{att}.self.query"),
                "k": lin(f"{att}.self.key"),
                "v": lin(f"{att}.self.value"),
                "proj": lin(f"{att}.output.dense"),
                "rel_bias": g(f"{att}.self.relative_position_bias_table"),
                "norm2": lin(f"{pre}.layernorm_after"),
                "fc1": lin(f"{pre}.intermediate.dense"),
                "fc2": lin(f"{pre}.output.dense")})
        ds = f"encoder.layers.{i}.downsample"
        if f"{ds}.reduction.weight" in state_dict:
            layer["downsample"] = {"norm": lin(f"{ds}.norm"),
                                   "reduction": lin(f"{ds}.reduction",
                                                    bias=False)}
        params["layers"].append(layer)
    return params


# ----------------------------------------------------------------------------
# Forward


def _layer_norm(p, x):
    return F.layer_norm(x, x.shape[-1:], p["weight"], p["bias"], LN_EPS)


def _dense(p, x):
    return F.linear(x, p["weight"], p.get("bias"))


def _rel_position_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]   # [ws*ws, ws*ws]


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x.reshape(n, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    n = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(n, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, -1)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Additive mask [num_windows, ws*ws, ws*ws] for shifted windows
    (0 within a region, -100 across regions, HF's convention)."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _on_device(device: torch.device, fn, *args) -> torch.Tensor:
    """``fn(*args)`` (a numpy array) as a tensor on ``device``, copied there
    once: a copy from pageable host memory waits for the stream."""
    return torch.from_numpy(fn(*args)).to(device)


def _block(p, x, h, w, heads, ws, shift):
    n, _, c = x.shape
    shortcut = x
    x = _layer_norm(p["norm1"], x).reshape(n, h, w, c)

    pad_b = (ws - h % ws) % ws
    pad_r = (ws - w % ws) % ws
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, w + pad_r

    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = _window_partition(x, ws)                         # [B*nw, ws*ws, C]
    del x

    head_dim = c // heads
    tokens = ws * ws

    def split(t):
        return t.reshape(-1, tokens, heads, head_dim).transpose(1, 2)

    q = split(_dense(p["q"], xw)) / math.sqrt(head_dim)
    k = split(_dense(p["k"], xw))
    v = split(_dense(p["v"], xw))
    del xw
    attn = q @ k.transpose(-2, -1)                        # [B*nw, h, T, T]
    del q, k

    idx = _on_device(p["rel_bias"].device, _rel_position_index, ws)
    bias = p["rel_bias"][idx.reshape(-1)].reshape(tokens, tokens, heads)
    attn = attn + bias.permute(2, 0, 1)[None]

    if shift > 0:
        mask = _on_device(attn.device, _shift_attn_mask, hp, wp, ws, shift)
        nw = mask.shape[0]
        attn = (attn.reshape(-1, nw, heads, tokens, tokens)
                + mask[None, :, None]).reshape(-1, heads, tokens, tokens)

    out = torch.softmax(attn, dim=-1) @ v
    del attn, v
    out = _dense(p["proj"], out.transpose(1, 2).reshape(-1, tokens, c))

    x = _window_reverse(out, ws, hp, wp)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    if pad_b or pad_r:
        x = x[:, :h, :w]
    x = shortcut + x.reshape(n, h * w, c)

    y = _layer_norm(p["norm2"], x)
    y = _dense(p["fc2"], F.gelu(_dense(p["fc1"], y)))
    return x + y


def _patch_merge(p, x, h, w):
    n, _, c = x.shape
    x = x.reshape(n, h, w, c)
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x0 = x[:, 0::2, 0::2]
    x1 = x[:, 1::2, 0::2]
    x2 = x[:, 0::2, 1::2]
    x3 = x[:, 1::2, 1::2]
    x = torch.cat([x0, x1, x2, x3], dim=-1)
    h2, w2 = x.shape[1], x.shape[2]
    x = _layer_norm(p["norm"], x.reshape(n, h2 * w2, 4 * c))
    return _dense(p["reduction"], x), h2, w2


def swin_features(cfg: SwinConfig, params: Params,
                  images: torch.Tensor) -> torch.Tensor:
    """Backbone features: images [N, 3, H, W] -> [N, H', W', C'] (the
    torchvision ``.features`` output the GA extractor consumes)."""
    n = images.shape[0]
    pe = params["patch_embed"]
    x = F.conv2d(images, pe["proj"]["weight"], stride=cfg.patch_size)
    x = x + pe["proj"]["bias"][None, :, None, None]
    h, w = x.shape[2], x.shape[3]
    x = _layer_norm(pe["norm"], x.permute(0, 2, 3, 1).reshape(n, h * w, -1))

    for i, layer in enumerate(params["layers"]):
        ws = min(cfg.window_size, h, w)
        for b, block in enumerate(layer["blocks"]):
            shift = 0 if b % 2 == 0 else (ws // 2 if min(h, w) > ws else 0)
            x = _block(block, x, h, w, cfg.num_heads[i], ws, shift)
        if "downsample" in layer:
            x, h, w = _patch_merge(layer["downsample"], x, h, w)

    return x.reshape(n, h, w, x.shape[-1])


def make_feature_extractor(cfg: Optional[SwinConfig] = None,
                           params: Optional[Params] = None,
                           gen: Optional[torch.Generator] = None,
                           device="cuda"):
    """The GA's feature fn: images [N, 3, H, W] in [-1, 1] -> [N, C'], the
    backbone features averaged over H', W' after ImageNet normalisation.
    Without ``params``: random ones from ``gen`` (seed 0 without it) on
    ``device``."""
    from .. import resolve_device

    cfg = cfg or swin_tiny_config()
    if params is None:
        params = init_swin(gen if gen is not None
                           else torch.Generator().manual_seed(0), cfg,
                           resolve_device(device))

    device = params["patch_embed"]["proj"]["weight"].device
    mean = torch.tensor(IMAGENET_MEAN, device=device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=device)[None, :, None, None]

    def extract(images: torch.Tensor) -> torch.Tensor:
        x = ((images + 1.0) / 2.0 - mean) / std
        with torch.no_grad():
            return swin_features(cfg, params, x).mean(dim=(1, 2))

    return extract
