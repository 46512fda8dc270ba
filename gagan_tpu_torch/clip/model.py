"""OpenAI CLIP (ViT image tower, causal text transformer) as functions over
a tree of tensors (port of gagan_tpu/clip/model.py).

Parameter keys are the JAX tree's, which follow the OpenAI state_dict
(``visual.conv1.weight``, ``visual.transformer.resblocks.N.attn.
in_proj_weight``, ...), so a ``vit_b_*.npz`` flattened with
``utils/checkpoint.tree_to_flat`` loads in both packages.

Numerics follow the JAX module: LayerNorm statistics and affine in fp32
whatever the compute dtype; attention scores computed in the compute dtype,
then scaled and soft-maxed in fp32; with ``dtype=torch.bfloat16`` the
matmuls run in bf16 while the pooled embedding and the hidden taps come
back in fp32.  The patch embedding is the stride-p conv written as patch
extraction and one matmul (the two are equal).  Attention is composed of
matmuls and a softmax, as XLA composes it in JAX: no kernel of its own.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize2d
from ..utils.checkpoint import tree_to_device
from ..utils.observability import traced

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # Vision.
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    # Text.
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    vision_heads_override: Optional[int] = None

    @property
    def vision_heads(self) -> int:
        if self.vision_heads_override is not None:
            return self.vision_heads_override
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size


VIT_B_32 = CLIPConfig(vision_patch_size=32)
VIT_B_16 = CLIPConfig(vision_patch_size=16)

# CLIP preprocessing constants (OpenAI _transform).
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with statistics and affine in fp32, result in x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w.to(x.dtype), b.to(x.dtype))


def _attention(p: Params, x: torch.Tensor, n_heads: int,
               attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head self-attention on [N, L, C] with torch MultiheadAttention
    parameters."""
    n, l, c = x.shape
    dt = x.dtype
    qkv = _linear(x, p["in_proj_weight"], p["in_proj_bias"])
    q, k, v = (t.reshape(n, l, n_heads, c // n_heads).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    scores = (q @ k.transpose(-1, -2)).float() / np.sqrt(c // n_heads)
    if attn_mask is not None:
        scores = scores + attn_mask
    attn = torch.softmax(scores, dim=-1).to(dt)
    out = (attn @ v).transpose(1, 2).reshape(n, l, c)
    return _linear(out, p["out_proj"]["weight"], p["out_proj"]["bias"])


def _resblock(p: Params, x: torch.Tensor, n_heads: int,
              attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = x + _attention(p["attn"], layer_norm(p["ln_1"], x), n_heads, attn_mask)
    y = layer_norm(p["ln_2"], x)
    y = quick_gelu(_linear(y, p["mlp"]["c_fc"]["weight"],
                           p["mlp"]["c_fc"]["bias"]))
    return x + _linear(y, p["mlp"]["c_proj"]["weight"],
                       p["mlp"]["c_proj"]["bias"])


def _transformer(p: Params, x: torch.Tensor, n_heads: int,
                 attn_mask: Optional[torch.Tensor] = None,
                 return_hidden: Sequence[int] = ()):
    hidden = {}
    for i in range(len(p["resblocks"])):
        x = _resblock(p["resblocks"][str(i)], x, n_heads, attn_mask)
        if i in return_hidden:
            hidden[i] = x
    return x, hidden


def preprocess_image(images: torch.Tensor, resolution: int = 224
                     ) -> torch.Tensor:
    """NCHW RGB in [0, 255] (uint8 or float) -> CLIP-normalized NCHW: a
    bicubic antialiased resize to ``resolution`` (ops/resize.py, in the
    input's float dtype) and the CLIP mean / std."""
    dt = images.dtype if images.is_floating_point() else torch.float32
    x = images.to(dt) / 255.0
    if tuple(x.shape[2:]) != (resolution, resolution):
        x = resize2d(x, (resolution, resolution), method="bicubic")
    mean, std = _mean_std(x.device, dt)
    return (x - mean) / std


@functools.lru_cache(maxsize=16)
def _mean_std(device: torch.device, dtype: torch.dtype):
    """The CLIP mean and std as [1, 3, 1, 1] tensors on ``device``, copied
    there once."""
    return tuple(torch.from_numpy(v).to(device=device, dtype=dtype)[
        None, :, None, None] for v in (IMAGE_MEAN, IMAGE_STD))


@traced("clip.encode_image", device=True)
def encode_image(cfg: CLIPConfig, params: Params, images: torch.Tensor,
                 normalize: bool = True, preprocess: bool = True,
                 return_hidden: Sequence[int] = (),
                 dtype: Optional[torch.dtype] = None
                 ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """Images -> (embedding [N, embed_dim], {layer: tokens [N, L, C]}).

    ``return_hidden`` layers give that resblock's output tokens without the
    CLS token, in fp32.  ``dtype`` (e.g. torch.bfloat16) runs the tower's
    matmuls, and the preprocessing resize, in that dtype; None runs fp32
    throughout."""
    v = params["visual"]
    x = images
    if preprocess:
        x = preprocess_image(x.to(dtype) if dtype is not None else x,
                             cfg.image_resolution)
    if dtype is not None:
        x = x.to(dtype)
    n, p = x.shape[0], cfg.vision_patch_size
    g = cfg.image_resolution // p
    xp = x.reshape(n, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    xp = xp.reshape(n, g * g, 3 * p * p)
    w1 = v["conv1"]["weight"].to(x.dtype).reshape(cfg.vision_width, -1)
    x = xp @ w1.t()                                          # [N, L, C]
    cls = v["class_embedding"].to(x.dtype).expand(n, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1) + v["positional_embedding"].to(x.dtype)
    x = layer_norm(v["ln_pre"], x)
    x, hidden = _transformer(v["transformer"], x, cfg.vision_heads,
                             return_hidden=return_hidden)
    pooled = layer_norm(v["ln_post"], x[:, 0]).float()
    emb = pooled @ v["proj"].float()
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb, {i: h[:, 1:].float() for i, h in hidden.items()}


def encode_text(cfg: CLIPConfig, params: Params,
                tokens: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Token ids [N, context_length] -> embedding [N, embed_dim]; the end
    token is found as the largest id (``argmax``), as in CLIP."""
    tokens = tokens.long()
    x = params["token_embedding"]["weight"][tokens]
    x = x + params["positional_embedding"]
    mask = torch.triu(torch.full((cfg.context_length, cfg.context_length),
                                 float("-inf"), device=x.device), diagonal=1)
    x, _ = _transformer(params["transformer"], x, cfg.transformer_heads,
                        attn_mask=mask)
    x = layer_norm(params["ln_final"], x)
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    emb = x @ params["text_projection"]
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb


# ----------------------------------------------------------------------------
# Random initialization (the JAX init's shapes and scales; torch draws):
# the fallback tower when no converted weights are present.


def _init_ln(width: int) -> Params:
    return {"weight": torch.ones((width,)), "bias": torch.zeros((width,))}


def _init_block(gen: torch.Generator, width: int) -> Params:
    def normal(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    return {
        "ln_1": _init_ln(width),
        "attn": {"in_proj_weight": normal(3 * width, width),
                 "in_proj_bias": torch.zeros((3 * width,)),
                 "out_proj": {"weight": normal(width, width),
                              "bias": torch.zeros((width,))}},
        "ln_2": _init_ln(width),
        "mlp": {"c_fc": {"weight": normal(4 * width, width),
                         "bias": torch.zeros((4 * width,))},
                "c_proj": {"weight": normal(width, 4 * width),
                           "bias": torch.zeros((width,))}},
    }


def init_clip(gen: torch.Generator, cfg: CLIPConfig = VIT_B_32,
              device="cpu") -> Params:
    """Random CLIP parameters drawn on the CPU from ``gen``, then moved to
    ``device``."""
    def normal(scale, *shape):
        return torch.randn(shape, generator=gen) * scale

    vw, tw = cfg.vision_width, cfg.transformer_width
    params = {
        "visual": {
            "conv1": {"weight": normal(0.02, vw, 3, cfg.vision_patch_size,
                                       cfg.vision_patch_size)},
            "class_embedding": normal(0.02, vw),
            "positional_embedding": normal(0.01, cfg.grid_size ** 2 + 1, vw),
            "ln_pre": _init_ln(vw),
            "transformer": {"resblocks": {
                str(i): _init_block(gen, vw)
                for i in range(cfg.vision_layers)}},
            "ln_post": _init_ln(vw),
            "proj": normal(0.02, vw, cfg.embed_dim),
        },
        "token_embedding": {"weight": normal(0.02, cfg.vocab_size, tw)},
        "positional_embedding": normal(0.01, cfg.context_length, tw),
        "transformer": {"resblocks": {
            str(i): _init_block(gen, tw)
            for i in range(cfg.transformer_layers)}},
        "ln_final": _init_ln(tw),
        "text_projection": normal(0.02, tw, cfg.embed_dim),
        "logit_scale": torch.tensor(np.log(1 / 0.07), dtype=torch.float32),
    }
    return tree_to_device(params, device)
