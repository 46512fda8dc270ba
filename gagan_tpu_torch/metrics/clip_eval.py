"""CLIP quality and diversity of an adapted generator (port of
gagan_tpu/metrics/clip_eval.py): quality is the mean cosine of the
generated images' CLIP embeddings to the target embedding, diversity the
mean (1 - cosine) over the distinct pairs of generated images."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..clip import model as clip_model
from ..models import stylegan2 as sg2
from ..train.adapt_losses import tril_mask


@dataclasses.dataclass
class CLIPEvalConfig:
    data_size: int = 500
    batch_size: int = 24
    truncation: float = 0.7


def clip_quality_diversity(embeddings: torch.Tensor,
                           target_emb: torch.Tensor) -> Tuple[float, float]:
    """``embeddings`` [N, D]; ``target_emb`` [D] or [T, D] (averaged)."""
    emb = embeddings / torch.linalg.vector_norm(embeddings, dim=-1,
                                                keepdim=True)
    trg = target_emb / torch.linalg.vector_norm(target_emb, dim=-1,
                                                keepdim=True)
    if trg.ndim == 2:
        trg = trg.mean(dim=0)
        trg = trg / torch.linalg.vector_norm(trg)
    quality = float((emb @ trg).mean())
    cos = emb @ emb.T
    mask = torch.from_numpy(tril_mask(emb.shape[0])).to(cos.device)
    diversity = float((1.0 - cos[mask]).mean())
    return quality, diversity


def evaluate_generator(cfg: CLIPEvalConfig, g_cfg: sg2.GeneratorConfig,
                       g_params, clip_cfg: clip_model.CLIPConfig, clip_params,
                       target_emb: torch.Tensor, key,
                       hooks=None) -> Dict[str, float]:
    """Sample ``data_size`` images (random noise; each batch's z and noise
    key split from ``key``, an ``Rng``) through the (adapted) generator and
    score them."""
    device = target_emb.device
    embs = []
    n = 0
    with torch.no_grad():
        while n < cfg.data_size:
            key, k_z, k_n = key.split(3)
            z = k_z.normal((cfg.batch_size, g_cfg.z_dim), device=device)
            img = sg2.generator_apply(g_cfg, g_params, z,
                                      truncation_psi=cfg.truncation,
                                      noise_mode="random", generator=k_n,
                                      hooks=hooks)
            img_u8 = torch.clamp(img * 127.5 + 128, 0, 255)
            emb, _ = clip_model.encode_image(clip_cfg, clip_params, img_u8)
            embs.append(emb.cpu().numpy())
            n += cfg.batch_size
    embs = torch.from_numpy(np.concatenate(embs)[: cfg.data_size]).to(device)
    quality, diversity = clip_quality_diversity(embs, target_emb)
    return {"clip_quality": quality, "clip_diversity": diversity}
