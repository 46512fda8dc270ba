"""Text-conditioned hypernetwork mappers producing per-conv offsets (port of
gagan_tpu/params/mappers.py).

An MLP backbone (shared, or one per level: coarse / medium / fine) over a
CLIP text embedding, with per-conv heads emitting channel-wise
multiplicative offsets {'in': [B, c_in], 'out': [B, c_out]}.  'in' scales
the styles and 'out' the conv's output, through the model's layer hooks.
Weights are drawn from a draw source (``fold_in`` / ``split`` /
``uniform``), so a test can hand in JAX's key tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..models.stylegan2 import LayerHooks, SynthesisConfig

Params = Dict[str, Any]

# The level split over the 17 convs of a 1024^2 generator; deeper convs of
# other depths fall in "fine".
LEVEL_SPLITS = {"coarse": (0, 5), "medium": (5, 9), "fine": (9, None)}


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    mapper_type: str = "residual_channelwise_sep"
    # base_channelwise_sep | residual_channelwise_sep | residual_channelin
    # | levelsheads_channelwise_sep
    backbone_type: str = "shared"        # shared | levels
    input_dimension: int = 512
    width: int = 512
    backbone_depth: int = 2
    head_depth: int = 2
    activation: str = "relu"
    no_coarse: bool = False
    no_medium: bool = False
    no_fine: bool = False


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "lrelu":
        return torch.where(x >= 0, x, 0.2 * x)
    if name == "id":
        return x
    raise ValueError(name)


def _init_linear(rng, n_in: int, n_out: int, device) -> Params:
    # xavier_uniform * 0.01, zero bias.
    limit = float(np.sqrt(6 / (n_in + n_out)))
    u = rng.uniform((n_out, n_in), device)
    w = (u * (2 * limit) - limit) * 0.01
    return {"weight": w, "bias": torch.zeros((n_out,), device=device)}


def _init_bn(n: int, device) -> Params:
    return {"weight": torch.ones((n,), device=device),
            "bias": torch.zeros((n,), device=device),
            "running_mean": torch.zeros((n,), device=device),
            "running_var": torch.ones((n,), device=device)}


def _bn_apply(p: Params, x: torch.Tensor, train: bool,
              eps: float = 1e-5) -> torch.Tensor:
    if train:
        mean = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
    else:
        mean, var = p["running_mean"], p["running_var"]
    x = (x - mean) * torch.rsqrt(var + eps)
    return x * p["weight"] + p["bias"]


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["weight"].T + p["bias"]


# BNLinRelu: bn(act(lin(x))).
def _init_bnlinrelu(rng, n_in, n_out, device):
    return {"lin": _init_linear(rng, n_in, n_out, device),
            "bn": _init_bn(n_out, device)}


def _bnlinrelu(p, x, activation, train):
    return _bn_apply(p["bn"], _act(activation, _linear(p["lin"], x)), train)


def _init_resblock(rng, features, device, inner=512):
    k1, k2 = rng.split(2)
    return {"lin1": _init_linear(k1, features, inner, device),
            "bn1": _init_bn(inner, device),
            "lin2": _init_linear(k2, inner, features, device),
            "bn2": _init_bn(features, device)}


def _resblock(p, x, activation, train):
    h = _bn_apply(p["bn1"], _linear(p["lin1"], x), train)
    h = _act(activation, h)
    h = _bn_apply(p["bn2"], _linear(p["lin2"], h), train)
    return _act(activation, h + x)


def _init_backbone(rng, cfg: MapperConfig, device):
    ks = rng.split(cfg.backbone_depth)
    p = {"stem": _init_bnlinrelu(ks[0], cfg.input_dimension, cfg.width,
                                 device)}
    for i in range(cfg.backbone_depth - 1):
        p[f"res{i}"] = _init_resblock(ks[i + 1], cfg.width, device)
    return p


def _backbone(p, cfg: MapperConfig, x, train):
    x = _bnlinrelu(p["stem"], x, cfg.activation, train)
    for i in range(cfg.backbone_depth - 1):
        x = _resblock(p[f"res{i}"], x, cfg.activation, train)
    return x


def _init_head(rng, cfg: MapperConfig, c_dim: int, residual: bool, device):
    ks = rng.split(cfg.head_depth)
    p = {}
    for i in range(cfg.head_depth - 1):
        p[f"h{i}"] = (_init_resblock(ks[i], cfg.width, device) if residual
                      else _init_bnlinrelu(ks[i], cfg.width, cfg.width,
                                           device))
    p["out"] = _init_linear(ks[-1], cfg.width, c_dim, device)
    return p


def _head(p, cfg: MapperConfig, x, residual: bool, train):
    for i in range(cfg.head_depth - 1):
        x = (_resblock(p[f"h{i}"], x, cfg.activation, train) if residual
             else _bnlinrelu(p[f"h{i}"], x, cfg.activation, train))
    return _linear(p["out"], x)


def conv_dimensions(syn_cfg: SynthesisConfig) -> List[Tuple[int, int]]:
    """(c_in, c_out) of each synthesis conv, torgbs skipped."""
    dims = []
    for res in syn_cfg.block_resolutions:
        if res > 4:
            dims.append((syn_cfg.channels(res // 2), syn_cfg.channels(res)))
        dims.append((syn_cfg.channels(res), syn_cfg.channels(res)))
    return dims


def _level_of(idx: int) -> str:
    for level, (lo, hi) in LEVEL_SPLITS.items():
        if idx >= lo and (hi is None or idx < hi):
            return level
    return "fine"


def _residual(cfg: MapperConfig) -> bool:
    return cfg.mapper_type.startswith(("residual", "levelsheads"))


def init_mapper(rng, cfg: MapperConfig, syn_cfg: SynthesisConfig,
                device="cpu") -> Params:
    """The mapper's weights, drawn from ``rng``: the backbone from ``rng``
    itself (per level from ``rng.fold_in(level index)``), conv ``i``'s heads
    from ``rng.fold_in(100 + i).fold_in(0 for 'in', 1 for 'out')``."""
    residual = _residual(cfg)
    in_only = cfg.mapper_type == "residual_channelin"
    p: Params = {}
    if cfg.backbone_type == "levels":
        p["backbone"] = {lvl: _init_backbone(rng.fold_in(i), cfg, device)
                         for i, lvl in enumerate(("coarse", "medium", "fine"))}
    else:
        p["backbone"] = _init_backbone(rng, cfg, device)
    heads: Params = {}
    for idx, (c_in, c_out) in enumerate(conv_dimensions(syn_cfg)):
        hk = rng.fold_in(100 + idx)
        entry = {"in": _init_head(hk.fold_in(0), cfg, c_in, residual, device)}
        if not in_only:
            entry["out"] = _init_head(hk.fold_in(1), cfg, c_out, residual,
                                      device)
        heads[f"conv_{idx}"] = entry
    p["heads"] = heads
    return p


def mapper_apply(params: Params, cfg: MapperConfig, syn_cfg: SynthesisConfig,
                 emb: torch.Tensor, train: bool = True
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """emb [B, input_dim] -> {conv_i: {'in': [B, c_in], 'out': [B, c_out]}};
    ``train`` normalizes with the batch's statistics, else with the running
    ones (which this function does not update)."""
    residual = _residual(cfg)
    if cfg.backbone_type == "levels":
        feats = {lvl: _backbone(params["backbone"][lvl], cfg, emb, train)
                 for lvl in ("coarse", "medium", "fine")}
    else:
        shared = _backbone(params["backbone"], cfg, emb, train)
        feats = {lvl: shared for lvl in ("coarse", "medium", "fine")}
    skip = {"coarse": cfg.no_coarse, "medium": cfg.no_medium,
            "fine": cfg.no_fine}
    out = {}
    for name, head in params["heads"].items():
        lvl = _level_of(int(name.split("_")[1]))
        entry = {}
        for kind, hp in head.items():
            val = _head(hp, cfg, feats[lvl], residual, train)
            entry[kind] = torch.zeros_like(val) if skip[lvl] else val
        out[name] = entry
    return out


def mapper_hooks(syn_cfg: SynthesisConfig,
                 mapper_out: Dict[str, Dict[str, torch.Tensor]]) -> LayerHooks:
    """Per-conv multiplicative offsets -> LayerHooks: 'in' on the styles
    (s * (1 + in)), 'out' on the conv output (y * (1 + out)); an 'out' hook
    keeps its layer off the fused level and its block unpacked."""
    names = [n for n in syn_cfg.layer_names() if not n.endswith("torgb")]
    hooks: LayerHooks = {}
    for idx, lname in enumerate(names):
        entry = mapper_out.get(f"conv_{idx}")
        if entry is None:
            continue
        h = {}
        if "in" in entry:
            h["style"] = lambda s, o=entry["in"]: s * (1.0 + o.to(s.dtype))
        if "out" in entry:
            h["post"] = lambda y, o=entry["out"]: y * (
                1.0 + o.to(y.dtype)[:, :, None, None])
        hooks[lname] = h
    return hooks
