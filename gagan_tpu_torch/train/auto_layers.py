"""Adaptive layer selection for domain adaptation, StyleGAN-NADA style (port
of gagan_tpu/train/auto_layers.py).

A probe optimizes a batch of W+ codes for ``auto_layer_iters`` SGD steps
against the global CLIP loss toward the target text, scores each w layer by
how far its codes moved, and the trainer unfreezes only the top-k layers:
a 0/1 gradient mask over the offsets tree.  The probe's layer noise is
drawn from a draw source (``key.fold_in(i)`` at step ``i``), so a test can
hand it JAX's draws.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..clip import model as clip_model
from ..models import stylegan2 as sg2


def make_layer_score_fn(g_cfg: sg2.GeneratorConfig,
                        clip_cfg: clip_model.CLIPConfig,
                        auto_layer_iters: int, lr: float = 0.01) -> Callable:
    """``score(g_params, clip_params, target_emb, z, key) -> [num_ws]``
    movement scores.  G and CLIP stay frozen: only the W+ codes take a
    gradient (the fused level's backward is asked for dx and d(styles))."""

    def global_clip_loss(cparams, img, target_emb):
        px = torch.clamp(img * 127.5 + 128, 0, 255)
        emb = clip_model.encode_image(clip_cfg, cparams, px)[0]
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        t = target_emb / torch.linalg.vector_norm(target_emb, dim=-1,
                                                  keepdim=True)
        if t.dim() > 1:
            # [T, D] or [1, T, D] template embeddings -> the mean direction.
            t = t.reshape(-1, t.shape[-1]).mean(0)
            t = t / torch.linalg.vector_norm(t)
        return (1.0 - emb @ t).mean()

    def score(g_params, clip_params, target_emb, z, key) -> torch.Tensor:
        with torch.no_grad():
            w = sg2.mapping_apply(g_cfg.mapping, g_params["mapping"], z,
                                  broadcast=False)
        w0 = w[:, None].repeat(1, g_cfg.num_ws, 1)
        w_codes = w0
        for i in range(auto_layer_iters):
            w_codes = w_codes.detach().requires_grad_(True)
            img = sg2.synthesis_apply(g_cfg.synthesis, g_params["synthesis"],
                                      w_codes, noise_mode="random",
                                      generator=key.fold_in(i))
            (g,) = torch.autograd.grad(
                global_clip_loss(clip_params, img, target_emb), w_codes)
            w_codes = w_codes.detach() - lr * g
        return (w_codes.detach() - w0).abs().mean(dim=-1).mean(dim=0)

    return score


def choose_layers(layer_scores, layer_names: Sequence[str],
                  auto_layer_k: int, skip_last: bool = True) -> List[str]:
    """Top-k layer names by movement score.  ``skip_last`` drops the last
    candidate (the final torgb on the offsets path).  Like the JAX
    function, score ``i`` (a w index) ranks ``layer_names[i]``."""
    if isinstance(layer_scores, torch.Tensor):
        layer_scores = layer_scores.detach().cpu().numpy()
    scores = np.asarray(layer_scores)
    names = list(layer_names)
    if skip_last:
        scores, names = scores[:-1], names[:-1]
    idx = np.argsort(scores)[::-1][:auto_layer_k]
    return [names[i] for i in idx]


def layer_grad_mask(offsets: Dict[str, Dict], chosen: Sequence[str]):
    """A 0/1 mask tree over the offsets: the gradients of the layers not
    ``chosen`` are zeroed."""
    chosen_set = set(chosen)

    def walk(node, on):
        if isinstance(node, dict):
            return {k: walk(v, on) for k, v in node.items()}
        return torch.tensor(1.0 if on else 0.0, dtype=node.dtype,
                            device=node.device)

    return {lname: walk(layer, lname in chosen_set)
            for lname, layer in offsets.items()}


def determine_opt_layers(key, g_cfg: sg2.GeneratorConfig, g_params,
                         clip_cfg: clip_model.CLIPConfig, clip_params,
                         target_embedding: torch.Tensor, *,
                         auto_layer_iters: int, auto_layer_batch: int,
                         auto_layer_k: int, lr: float = 0.01
                         ) -> Tuple[List[str], torch.Tensor]:
    """(chosen layer names, the [num_ws] scores) from one probe: ``key``
    splits into the latents' key and the probe's noise key."""
    k_z, k_opt = key.split(2)
    device = target_embedding.device
    z = k_z.normal((auto_layer_batch, g_cfg.z_dim), device)
    scores = make_layer_score_fn(g_cfg, clip_cfg, auto_layer_iters, lr)(
        g_params, clip_params, target_embedding, z, k_opt)
    return (choose_layers(scores, g_cfg.synthesis.layer_names(), auto_layer_k),
            scores)
