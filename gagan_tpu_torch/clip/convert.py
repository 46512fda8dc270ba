"""Convert pretrained CLIP state dicts into the port's CLIP trees (port of
gagan_tpu/clip/convert.py).

Two source layouts:
  * the OpenAI ``clip`` state_dict (``visual.conv1.weight``, ...): the
    trees follow its naming, so only ``input_resolution*`` is dropped;
  * the HuggingFace ``CLIPModel`` state_dict: renamed, q/k/v concatenated
    into ``in_proj_*`` and the two projections transposed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _nest(flat: Mapping[str, Any], device) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(np.array(value), device=device)
    return tree


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def from_openai_state_dict(sd: Mapping[str, Any], device="cpu") -> Dict[str, Any]:
    """OpenAI clip state_dict -> the port's CLIP tree (naming already
    matches)."""
    return _nest({k: _numpy(v) for k, v in sd.items()
                  if not k.startswith("input_resolution")}, device)


def from_hf_state_dict(sd: Mapping[str, Any], device="cpu") -> Dict[str, Any]:
    """transformers.CLIPModel.state_dict() -> the port's CLIP tree."""
    sd = {k: _numpy(v) for k, v in sd.items()}
    out: Dict[str, np.ndarray] = {}

    def block_map(prefix_src: str, prefix_dst: str, n_layers: int):
        for i in range(n_layers):
            s = f"{prefix_src}.layers.{i}"
            d = f"{prefix_dst}.resblocks.{i}"
            out[f"{d}.attn.in_proj_weight"] = np.concatenate(
                [sd[f"{s}.self_attn.{p}_proj.weight"] for p in "qkv"])
            out[f"{d}.attn.in_proj_bias"] = np.concatenate(
                [sd[f"{s}.self_attn.{p}_proj.bias"] for p in "qkv"])
            out[f"{d}.attn.out_proj.weight"] = sd[f"{s}.self_attn.out_proj.weight"]
            out[f"{d}.attn.out_proj.bias"] = sd[f"{s}.self_attn.out_proj.bias"]
            out[f"{d}.ln_1.weight"] = sd[f"{s}.layer_norm1.weight"]
            out[f"{d}.ln_1.bias"] = sd[f"{s}.layer_norm1.bias"]
            out[f"{d}.ln_2.weight"] = sd[f"{s}.layer_norm2.weight"]
            out[f"{d}.ln_2.bias"] = sd[f"{s}.layer_norm2.bias"]
            out[f"{d}.mlp.c_fc.weight"] = sd[f"{s}.mlp.fc1.weight"]
            out[f"{d}.mlp.c_fc.bias"] = sd[f"{s}.mlp.fc1.bias"]
            out[f"{d}.mlp.c_proj.weight"] = sd[f"{s}.mlp.fc2.weight"]
            out[f"{d}.mlp.c_proj.bias"] = sd[f"{s}.mlp.fc2.bias"]

    n_vis = 1 + max(int(k.split(".")[3]) for k in sd
                    if k.startswith("vision_model.encoder.layers."))
    n_txt = 1 + max(int(k.split(".")[3]) for k in sd
                    if k.startswith("text_model.encoder.layers."))
    block_map("vision_model.encoder", "visual.transformer", n_vis)
    block_map("text_model.encoder", "transformer", n_txt)

    out["visual.conv1.weight"] = sd["vision_model.embeddings.patch_embedding.weight"]
    out["visual.class_embedding"] = sd["vision_model.embeddings.class_embedding"]
    out["visual.positional_embedding"] = sd[
        "vision_model.embeddings.position_embedding.weight"]
    out["visual.ln_pre.weight"] = sd["vision_model.pre_layrnorm.weight"]
    out["visual.ln_pre.bias"] = sd["vision_model.pre_layrnorm.bias"]
    out["visual.ln_post.weight"] = sd["vision_model.post_layernorm.weight"]
    out["visual.ln_post.bias"] = sd["vision_model.post_layernorm.bias"]
    out["visual.proj"] = sd["visual_projection.weight"].T

    out["token_embedding.weight"] = sd[
        "text_model.embeddings.token_embedding.weight"]
    out["positional_embedding"] = sd[
        "text_model.embeddings.position_embedding.weight"]
    out["ln_final.weight"] = sd["text_model.final_layer_norm.weight"]
    out["ln_final.bias"] = sd["text_model.final_layer_norm.bias"]
    out["text_projection"] = sd["text_projection.weight"].T
    out["logit_scale"] = sd["logit_scale"]
    return _nest(out, device)
