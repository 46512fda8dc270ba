"""StyleGAN2 adversarial losses (frozen copy of the port's
train/gan_loss.py, cut to what the benchmark's reference runs):
non-saturating logistic G/D losses as one simultaneous Gmain+Dmain,
path-length regularization with the ``pl_mean`` moving average, the R1
gradient penalty and style mixing, on unconditional networks.

Each loss returns ``(loss, metrics)`` with the metrics detached.  Random
draws come from a key of utils/rng.py, split as the port splits its key.
The gradient-of-gradient terms (PL, R1) are ``torch.autograd.grad(...,
create_graph=True)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models import stylegan2 as sg2

Params = Dict[str, Any]
# augment_fn(img, p, key) -> img; ``p`` is the ADA probability.
AugmentFn = Optional[Callable[[torch.Tensor, Any, Any], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class GANLossConfig:
    style_mixing_prob: float = 0.9
    r1_gamma: float = 10.0
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    pl_weight: float = 2.0


def softplus(x: torch.Tensor) -> torch.Tensor:
    # -log(sigmoid(-x)), as the JAX module writes it.
    return torch.where(x > 20.0, x, torch.log1p(torch.exp(torch.clamp_max(
        x, 20.0))))


def _detached(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in metrics.items()}


def run_mapping_with_mixing(g_cfg: sg2.GeneratorConfig, g_params: Params,
                            z: torch.Tensor, key,
                            style_mixing_prob: float) -> torch.Tensor:
    """Mapping + style mixing: with probability ``style_mixing_prob`` the
    layers from a cutoff ~ U{1..num_ws-1} on take the mapping of a fresh z.
    The choice stays on the device (no host sync)."""
    ws = sg2.mapping_apply(g_cfg.mapping, g_params["mapping"], z)
    if style_mixing_prob <= 0:
        return ws
    k1, k2, k3 = key.split(3)
    num_ws = g_cfg.num_ws
    dev = z.device
    cutoff = k1.randint((), 1, num_ws, device=dev)
    cutoff = torch.where(k2.uniform((), device=dev) < style_mixing_prob,
                         cutoff, num_ws)
    z2 = k3.normal(z.shape, device=dev).to(z.dtype)
    ws2 = sg2.mapping_apply(g_cfg.mapping, g_params["mapping"], z2)
    layer_idx = torch.arange(num_ws, device=dev)[None, :, None]
    return torch.where(layer_idx < cutoff, ws, ws2)


def run_G(g_cfg: sg2.GeneratorConfig, g_params: Params, z: torch.Tensor,
          key, style_mixing_prob: float,
          hooks: Optional[sg2.LayerHooks] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    k_mix, k_noise = key.split(2)
    ws = run_mapping_with_mixing(g_cfg, g_params, z, k_mix,
                                 style_mixing_prob)
    img = sg2.synthesis_apply(g_cfg.synthesis, g_params["synthesis"], ws,
                              noise_mode="random", generator=k_noise,
                              hooks=hooks)
    return img, ws


def run_D(d_cfg: sg2.DiscriminatorConfig, d_params: Params,
          img: torch.Tensor, augment_fn: AugmentFn, ada_p,
          key) -> torch.Tensor:
    if augment_fn is not None:
        img = augment_fn(img, ada_p, key)
    return sg2.discriminator_apply(d_cfg, d_params, img)


def g_pl_loss(cfg: GANLossConfig, g_cfg: sg2.GeneratorConfig,
              g_params: Params, z: torch.Tensor, key, pl_mean: torch.Tensor,
              hooks: Optional[sg2.LayerHooks] = None):
    """Greg: path-length regularization.  ``metrics['aux/pl_mean']`` is the
    updated moving average (the trainer stores it).  The PL batch is the
    first ``1 / pl_batch_shrink`` of ``z``."""
    batch = z.shape[0] // cfg.pl_batch_shrink
    z = z[:batch]
    k_mix, k_noise, k_pl = key.split(3)
    ws = run_mapping_with_mixing(g_cfg, g_params, z, k_mix,
                                 cfg.style_mixing_prob)
    if not ws.requires_grad:
        # A frozen mapping net: nothing before ws takes a gradient, so ws
        # becomes the leaf that the path-length VJP differentiates.
        ws = ws.detach().requires_grad_(True)
    img = sg2.synthesis_apply(g_cfg.synthesis, g_params["synthesis"], ws,
                              noise_mode="random", generator=k_noise,
                              hooks=hooks)
    pl_noise = k_pl.normal(img.shape, device=img.device).to(img.dtype) / (
        np.sqrt(img.shape[2] * img.shape[3]))
    # d/dws sum(img * noise): one VJP through the synthesis network, kept
    # in the graph so that the penalty differentiates through it.
    (pl_grads,) = torch.autograd.grad((img * pl_noise).sum(), ws,
                                      create_graph=True)
    pl_lengths = pl_grads.square().sum(dim=2).mean(dim=1).sqrt()
    lengths_mean = pl_lengths.mean()
    new_pl_mean = (pl_mean + cfg.pl_decay * (lengths_mean - pl_mean)
                   ).detach()
    pl_penalty = (pl_lengths - new_pl_mean).square()
    loss = pl_penalty.mean() * cfg.pl_weight
    metrics = {
        "Loss/pl_penalty": pl_penalty.mean(),
        "Loss/G/reg": loss,
        "aux/pl_mean": new_pl_mean,
    }
    return loss, _detached(metrics)


def gd_main_loss(cfg: GANLossConfig, g_cfg: sg2.GeneratorConfig,
                 d_cfg: sg2.DiscriminatorConfig, g_params: Params,
                 d_params: Params, real_img: torch.Tensor, z: torch.Tensor,
                 key, augment_fn: AugmentFn = None, ada_p=None,
                 hooks: Optional[sg2.LayerHooks] = None):
    """Gmain + Dmain as one scalar over one G forward: loss_g sees detached
    D parameters and loss_d detached fakes, so one backward of the sum gives
    exactly the per-phase gradients.  The fake is augmented with one key on
    both routes (one augment draw per image, as in the JAX module).  JAX's
    compiler merges the two D(fake) forwards into one; eager torch runs both
    (the G route needs the image gradient, the D route the parameters')."""
    k_g, k_aug, _k_ga = key.split(3)
    k_aug1, k_aug2 = k_aug.split(2)
    gen_img, gen_ws = run_G(g_cfg, g_params, z, k_g,
                            cfg.style_mixing_prob, hooks)

    # G route: D with frozen parameters.
    d_frozen = sg2.tree_map(torch.Tensor.detach, d_params)
    gen_logits_g = run_D(d_cfg, d_frozen, gen_img, augment_fn, ada_p, k_aug1)
    loss_g = softplus(-gen_logits_g).mean()

    # D route: the same fake, detached.
    gen_logits_d = run_D(d_cfg, d_params, gen_img.detach(), augment_fn,
                         ada_p, k_aug1)
    real_logits = run_D(d_cfg, d_params, real_img, augment_fn, ada_p, k_aug2)
    loss_d = softplus(gen_logits_d).mean() + softplus(-real_logits).mean()
    metrics = {
        "Loss/scores/fake": gen_logits_d.mean(),
        "Loss/signs/fake": torch.sign(gen_logits_d).mean(),
        "Loss/scores/real": real_logits.mean(),
        "Loss/signs/real": torch.sign(real_logits).mean(),
        "Loss/G/loss": loss_g,
        "Loss/D/loss": loss_d,
        "aux/mean_w": gen_ws[:, 0].float().mean(dim=0),
    }
    return loss_g + loss_d, _detached(metrics)


def d_r1_loss(cfg: GANLossConfig, d_cfg: sg2.DiscriminatorConfig,
              d_params: Params, real_img: torch.Tensor, key,
              augment_fn: AugmentFn = None, ada_p=None):
    """Dreg: R1 gradient penalty on reals, through the augment pipe."""
    img = real_img.detach().requires_grad_(True)
    logits = run_D(d_cfg, d_params, img, augment_fn, ada_p, key)
    (grads,) = torch.autograd.grad(logits.sum(), img, create_graph=True)
    r1_penalty = grads.square().sum(dim=(1, 2, 3))
    loss = r1_penalty.mean() * (cfg.r1_gamma / 2.0)
    metrics = {
        "Loss/r1_penalty": r1_penalty.mean(),
        "Loss/D/reg": loss,
        "Loss/scores/real": logits.mean(),
        "Loss/signs/real": torch.sign(logits).mean(),
    }
    return loss, _detached(metrics)
