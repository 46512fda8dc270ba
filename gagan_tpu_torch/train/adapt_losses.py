"""CLIP-guided domain-adaptation losses (port of
gagan_tpu/train/adapt_losses.py): the clip / rec / reg registries, the
composite ``direct_loss`` and the DiFa SCC (difa_w) latent loss, whose
sliding window is a fixed-size circular buffer of plain tensors passed in
and returned (no host read)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
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


def tril_mask(n: int) -> np.ndarray:
    """Strictly lower-triangular [n, n] bool mask."""
    mask = np.zeros((n, n), dtype=bool)
    mask[np.tril_indices(n)] = True
    np.fill_diagonal(mask, False)
    return mask


def _tril(n: int, device) -> torch.Tensor:
    return torch.from_numpy(tril_mask(n)).to(device)


# ----------------------------------------------------------------------------
# CLIP losses over a clip batch {trg_encoded, src_encoded, trg_domain_emb,
# src_domain_emb, trg_tokens, ...}.

clip_losses: Dict[str, Callable] = {}
rec_losses: Dict[str, Callable] = {}
reg_losses: Dict[str, Callable] = {}


def _register(registry, name):
    def deco(fn):
        registry[name] = fn
        return fn

    return deco


@_register(clip_losses, "global")
def global_loss(cb):
    return cosine_loss(cb["trg_encoded"], cb["trg_domain_emb"]).mean()


@_register(clip_losses, "direction")
def direction_loss(cb):
    """Cosine between the image edit and the domain edit; [1, T, D] domain
    embeddings are averaged over the T templates first."""
    edit_im = cb["trg_encoded"] - cb["src_encoded"]
    edit_domain = cb["trg_domain_emb"] - cb["src_domain_emb"]
    if edit_domain.ndim == 3:
        edit_domain = edit_domain.mean(dim=1)
    return cosine_loss(edit_im, edit_domain).mean()


@_register(clip_losses, "indomain")
def indomain_loss(cb):
    src, trg = cb["src_encoded"], cb["trg_encoded"]
    n = src.shape[0]
    mask = _tril(n, src.device)
    src_cos = (src @ src.T)[mask]
    trg_cos = (trg @ trg.T)[mask]
    return (src_cos - trg_cos).square().sum() / n / (n - 1) * 2


@_register(clip_losses, "tt_direction")
def tt_direction_loss(cb):
    trg, trg_emb = cb["trg_encoded"], cb["trg_domain_emb"]
    mask = _tril(trg.shape[0], trg.device)
    deltas_text = (trg_emb[None] - trg_emb[:, None])[mask]
    deltas_img = (trg[None] - trg[:, None])[mask]
    if trg_emb.ndim == 3:
        deltas_text = deltas_text.mean(dim=1)
    return cosine_loss(deltas_img, deltas_text).mean()


@_register(clip_losses, "clip_within")
def clip_within_loss(cb):
    trg_dir = cb["trg_encoded"] - cb["trg_domain_emb"]
    src_dir = cb["src_encoded"] - cb["src_domain_emb"]
    return cosine_loss(trg_dir, src_dir).mean()


@_register(clip_losses, "clip_ref")
def clip_ref_loss(cb):
    return cosine_loss(cb["trg_trainable_emb"], cb["trg_emb"]).mean()


@_register(clip_losses, "difa_local")
def difa_local_loss(cb):
    """Token matching, a relaxed earth mover's distance."""
    tgt = cb["trg_tokens"]
    style = cb["trg_tokens_style"]
    if style.ndim == 2:
        style = style[None]
    style = style.expand((tgt.shape[0],) + style.shape[1:])
    attn = torch.einsum("bnc,bmc->bnm", _safe_normalize(tgt),
                        _safe_normalize(style))
    cost = 1.0 - attn
    row = cost.min(dim=2).values.mean(dim=1)
    col = cost.min(dim=1).values.mean(dim=1)
    return torch.maximum(row, col).mean()


# ----------------------------------------------------------------------------
# Reconstruction losses.


@_register(rec_losses, "l2_rec_resized")
def l2_rec_resized(rd):
    return (rd["style_inverted_B_256x256"]
            - rd["style_image_256x256"]).square().mean()


@_register(rec_losses, "l2_rec_fullres")
def l2_rec_fullres(rd):
    return (rd["style_inverted_B_1024x1024"]
            - rd["style_image_1024x1024"]).square().mean()


@_register(rec_losses, "lpips_rec")
def lpips_rec(rd):
    """LPIPS from the embeddings given in the rec data."""
    a, b = rd["style_inverted_B_lpips"], rd["style_image_lpips"]
    return (a - b).square().sum(dim=-1).mean()


@_register(rec_losses, "disc_feat_matching")
def disc_feat_matching(rd):
    """L1 over lists of discriminator features."""
    fake_feats, real_feats = rd["disc_feats_fake"], rd["disc_feats_real"]
    total = 0.0
    for a, b in zip(fake_feats, real_feats):
        b = b.repeat((a.shape[0] // b.shape[0],) + (1,) * (b.ndim - 1))
        total = total + (a - b).abs().mean()
    return total / len(fake_feats)


# ----------------------------------------------------------------------------
# Regularization losses on the offsets.


def _layer_delta_sum(conv_inputs: Dict[str, torch.Tensor]):
    return sum(v for v in conv_inputs.values() if not isinstance(v, dict))


@_register(reg_losses, "offsets_l2")
def offsets_l2(offsets):
    loss = 0.0
    for conv_inputs in offsets.values():
        delta = _layer_delta_sum(conv_inputs)
        loss = loss + delta.square().sum() / delta.numel()
    return loss


@_register(reg_losses, "offsets_l1")
def offsets_l1(offsets):
    loss = 0.0
    for conv_inputs in offsets.values():
        delta = _layer_delta_sum(conv_inputs)
        loss = loss + delta.abs().sum() / delta.numel()
    return loss


@_register(reg_losses, "affine_l2")
def affine_l2(offsets):
    loss = 0.0
    for conv_inputs in offsets.values():
        gamma, beta = conv_inputs["gamma"], conv_inputs["beta"]
        val = ((gamma - 1).square() + beta.square()).sum()
        loss = loss + val / gamma.numel()
    return loss


# ----------------------------------------------------------------------------
# SCC (difa_w) loss with an explicit sliding window.


@dataclasses.dataclass
class SCCState:
    source_set: torch.Tensor     # [window, D]
    target_set: torch.Tensor
    count: torch.Tensor          # filled entries (int64 scalar)
    pos: torch.Tensor            # circular write position (int64 scalar)


def init_scc_state(latent_dim: int, window: int = 50,
                   device="cpu") -> SCCState:
    return SCCState(
        source_set=torch.zeros((window, latent_dim), device=device),
        target_set=torch.zeros((window, latent_dim), device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
        pos=torch.zeros((), dtype=torch.int64, device=device))


@dataclasses.dataclass(frozen=True)
class SCCConfig:
    weight: float = 6.0
    num_keep_first: int = 7
    sliding_window_size: int = 50
    psp_alpha: float = 0.6
    latent_dim: int = 512


def scc_loss(cfg: SCCConfig, state: SCCState, src_latents, trg_latents,
             cur_iter, total_iters) -> Tuple[torch.Tensor, SCCState]:
    """difa_w dynamic loss on flattened W+ latents [B, num_ws * w_dim]; the
    kept prefix length is the width of the state's buffers."""
    keep = state.source_set.shape[1]
    src = src_latents[:, :keep]
    trg = trg_latents[:, :keep]
    w = cfg.sliding_window_size
    pos = (state.pos % w).reshape(1)
    state = SCCState(
        source_set=state.source_set.index_copy(
            0, pos, src.mean(dim=0).detach()[None]),
        target_set=state.target_set.index_copy(
            0, pos, trg.mean(dim=0).detach()[None]),
        count=torch.clamp(state.count + 1, max=w),
        pos=(state.pos + 1) % w)
    denom = torch.clamp(state.count, min=1).float()
    valid = (torch.arange(w, device=src.device) < state.count)[:, None]
    delta_w = ((state.target_set * valid).sum(dim=0)
               - (state.source_set * valid).sum(dim=0)) / denom
    regular_weight = max(0.0, (float(cur_iter) - w) / max(total_iters - w, 1))
    # Keep the psp_alpha share of channels with the smallest |delta_w|.
    k = int(cfg.psp_alpha * keep)
    order = torch.argsort(delta_w.abs(), stable=True)
    cond = torch.zeros((keep,), device=src.device).index_fill(0, order[:k], 1.0)
    l1 = (cond * trg - cond * src).abs().mean()
    return cfg.weight * regular_weight * l1, state


# ----------------------------------------------------------------------------
# Composite.


@dataclasses.dataclass(frozen=True)
class DirectLossConfig:
    loss_funcs: Tuple[str, ...] = ("direction",)
    loss_coefs: Tuple[float, ...] = (1.0,)
    scc: Optional[SCCConfig] = None


def direct_loss(cfg: DirectLossConfig, batch: Dict[str, Any],
                scc_state: Optional[SCCState] = None):
    """(losses dict with 'total', new SCC state)."""
    losses: Dict[str, torch.Tensor] = {}
    for func, coef in zip(cfg.loss_funcs, cfg.loss_coefs):
        if func in clip_losses:
            for enc_key, cb in batch["clip_data"].items():
                tag = enc_key.replace("/", "-")
                losses[f"{func}_{tag}"] = coef * clip_losses[func](cb)
        elif func in rec_losses and batch.get("rec_data"):
            losses[func] = coef * rec_losses[func](batch["rec_data"])
        elif func in reg_losses and batch.get("offsets") is not None:
            losses[func] = coef * reg_losses[func](batch["offsets"])

    if cfg.scc is not None and scc_state is not None:
        inv = batch["inv_data"]
        losses["difa_psp_loss"], scc_state = scc_loss(
            cfg.scc, scc_state, inv["src_latents"], inv["trg_latents"],
            inv["iters"], inv["total_iters"])

    losses["total"] = sum(losses.values())
    return losses, scc_state
