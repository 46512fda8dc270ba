"""The flat StyleSpace direction model (port of gagan_tpu/params/sparse.py).

Every synthesis conv's style vector concatenated into one flat delta vector
(6048 dims at 1024^2, the "StyleSpace direction" of the paper), with the
conv <-> style-layer index maps, magnitude pruning, and the conversion to
the additive offsets tree and its hooks.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..models.stylegan2 import LayerHooks, SynthesisConfig


def conv_layer_names(syn_cfg: SynthesisConfig) -> List[str]:
    """Synthesis conv layers (torgb excluded), in flat-vector order."""
    return [n for n in syn_cfg.layer_names() if not n.endswith("torgb")]


def conv_style_dims(syn_cfg: SynthesisConfig) -> List[int]:
    names = syn_cfg.layer_names()
    dims = syn_cfg.layer_in_channels()
    return [d for n, d in zip(names, dims) if not n.endswith("torgb")]


def flat_dim(syn_cfg: SynthesisConfig) -> int:
    """6048 for the 1024^2 FFHQ generator."""
    return sum(conv_style_dims(syn_cfg))


def split_flat(syn_cfg: SynthesisConfig,
               deltas: torch.Tensor) -> List[torch.Tensor]:
    """The flat vector's per-conv segments (views on its last axis)."""
    out = []
    start = 0
    for d in conv_style_dims(syn_cfg):
        out.append(deltas[..., start: start + d])
        start += d
    return out


def to_offsets(syn_cfg: SynthesisConfig, deltas: torch.Tensor) -> Dict:
    """Flat vector -> additive StyleSpace offsets tree keyed by layer name
    (the hooks of ``OffsetsSpec(style="additive")``)."""
    return {name: {"offset": seg.reshape(1, -1)}
            for name, seg in zip(conv_layer_names(syn_cfg),
                                 split_flat(syn_cfg, deltas))}


def to_hooks(syn_cfg: SynthesisConfig, deltas: torch.Tensor) -> LayerHooks:
    from .offsets import OffsetsSpec, make_hooks

    return make_hooks(OffsetsSpec(style="additive"),
                      to_offsets(syn_cfg, deltas))


def from_offsets(syn_cfg: SynthesisConfig, offsets: Dict) -> torch.Tensor:
    """The inverse of :func:`to_offsets`."""
    return torch.cat([offsets[name]["offset"].reshape(-1)
                      for name in conv_layer_names(syn_cfg)])


def pruned(deltas: torch.Tensor, perc: float) -> torch.Tensor:
    """Zero the ``perc`` fraction of entries of smallest |delta| (ties in
    index order)."""
    flat = deltas.reshape(-1)
    order = torch.argsort(flat.abs(), stable=True)
    mask = torch.ones_like(flat)
    mask[order[:int(flat.shape[0] * perc)]] = 0.0
    return (flat * mask).reshape(deltas.shape)


def conv_to_style_layer_index(syn_cfg: SynthesisConfig) -> Dict[int, int]:
    """conv index -> its index among all layers, torgbs included."""
    out = {}
    conv_idx = 0
    for i, n in enumerate(syn_cfg.layer_names()):
        if not n.endswith("torgb"):
            out[conv_idx] = i
            conv_idx += 1
    return out


def w_idx_to_style_idx(syn_cfg: SynthesisConfig) -> Dict[int, int]:
    """w index -> style-layer index: the convs take w indices
    0..num_conv-1 in order, and the last torgb takes num_conv (an earlier
    torgb's index is taken over by the next block's first conv)."""
    out = {}
    w_idx = 0
    for i, n in enumerate(syn_cfg.layer_names()):
        if n.endswith("torgb"):
            out.setdefault(w_idx, i)
        else:
            out[w_idx] = i
            w_idx += 1
    return out
