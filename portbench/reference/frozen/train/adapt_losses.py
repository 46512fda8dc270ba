"""The one-shot adaptation losses (frozen copy of the port's
train/adapt_losses.py, cut to what the benchmark's td_single reference
runs): the CLIP ``direction`` loss, the ``offsets_l2`` regularizer and the
composite ``direct_loss``."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch


def _safe_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x / sqrt(||x||^2 + eps^2): the clamp scale of
    ``torch.cosine_similarity`` with a finite gradient at x == 0.  That case
    is reached: with zero offsets the trainable and frozen halves of the
    joint synthesis pass are equal bit for bit, so the first step's CLIP
    edit direction is exactly 0 (``cosine_similarity``'s backward would
    give another gradient there)."""
    return x / torch.sqrt(x.square().sum(dim=-1, keepdim=True) + eps * eps)


def cosine_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity along the last axis."""
    return 1.0 - (_safe_normalize(x) * _safe_normalize(y)).sum(dim=-1)


# ----------------------------------------------------------------------------
# CLIP losses over a clip batch {trg_encoded, src_encoded, trg_domain_emb,
# src_domain_emb}, and regularization losses on the offsets.

clip_losses: Dict[str, Callable] = {}
reg_losses: Dict[str, Callable] = {}


def _register(registry, name):
    def deco(fn):
        registry[name] = fn
        return fn

    return deco


@_register(clip_losses, "direction")
def direction_loss(cb):
    """Cosine between the image edit and the domain edit; [1, T, D] domain
    embeddings are averaged over the T templates first."""
    edit_im = cb["trg_encoded"] - cb["src_encoded"]
    edit_domain = cb["trg_domain_emb"] - cb["src_domain_emb"]
    if edit_domain.ndim == 3:
        edit_domain = edit_domain.mean(dim=1)
    return cosine_loss(edit_im, edit_domain).mean()


def _layer_delta_sum(conv_inputs: Dict[str, torch.Tensor]):
    return sum(v for v in conv_inputs.values() if not isinstance(v, dict))


@_register(reg_losses, "offsets_l2")
def offsets_l2(offsets):
    loss = 0.0
    for conv_inputs in offsets.values():
        delta = _layer_delta_sum(conv_inputs)
        loss = loss + delta.square().sum() / delta.numel()
    return loss


# ----------------------------------------------------------------------------
# Composite.


@dataclasses.dataclass(frozen=True)
class DirectLossConfig:
    loss_funcs: Tuple[str, ...] = ("direction",)
    loss_coefs: Tuple[float, ...] = (1.0,)


def direct_loss(cfg: DirectLossConfig, batch: Dict[str, Any]
                ) -> Dict[str, torch.Tensor]:
    """The losses of ``batch`` ({"clip_data": {encoder: clip batch},
    "offsets": tree}) with their sum under 'total'."""
    losses: Dict[str, torch.Tensor] = {}
    for func, coef in zip(cfg.loss_funcs, cfg.loss_coefs):
        if func in clip_losses:
            for enc_key, cb in batch["clip_data"].items():
                tag = enc_key.replace("/", "-")
                losses[f"{func}_{tag}"] = coef * clip_losses[func](cb)
        elif func in reg_losses and batch.get("offsets") is not None:
            losses[func] = coef * reg_losses[func](batch["offsets"])
        else:
            raise ValueError(f"no loss {func!r} in the reference")
    losses["total"] = sum(losses.values())
    return losses
