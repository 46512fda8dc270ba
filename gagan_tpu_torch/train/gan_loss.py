"""StyleGAN2 adversarial losses (port of gagan_tpu/train/gan_loss.py):
non-saturating logistic G/D losses, path-length regularization with the
``pl_mean`` moving average, the R1 gradient penalty, style mixing and the
GA-fakes splice.

Each loss returns ``(loss, metrics)`` as the JAX module does, with the
metrics detached.  Random draws come from a key of utils/rng.py, split as
the JAX module splits its key: the mixing cutoff and second z, the layer
noise, the path-length noise and the augment draws each have the key that
JAX gives them, so a test can inject JAX's draws.  The gradient-of-gradient
terms (PL, R1) are ``torch.autograd.grad(..., create_graph=True)``, standing
in for ``jax.vjp`` / ``jax.grad``.
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
                            z: torch.Tensor, c: Optional[torch.Tensor], key,
                            style_mixing_prob: float) -> torch.Tensor:
    """Mapping + style mixing: with probability ``style_mixing_prob`` the
    layers from a cutoff ~ U{1..num_ws-1} on take the mapping of a fresh z.
    The choice stays on the device (no host sync)."""
    ws = sg2.mapping_apply(g_cfg.mapping, g_params["mapping"], z, c)
    if style_mixing_prob <= 0:
        return ws
    k1, k2, k3 = key.split(3)
    num_ws = g_cfg.num_ws
    dev = z.device
    cutoff = k1.randint((), 1, num_ws, device=dev)
    cutoff = torch.where(k2.uniform((), device=dev) < style_mixing_prob,
                         cutoff, num_ws)
    z2 = k3.normal(z.shape, device=dev).to(z.dtype)
    ws2 = sg2.mapping_apply(g_cfg.mapping, g_params["mapping"], z2, c)
    layer_idx = torch.arange(num_ws, device=dev)[None, :, None]
    return torch.where(layer_idx < cutoff, ws, ws2)


def run_G(g_cfg: sg2.GeneratorConfig, g_params: Params, z: torch.Tensor,
          c: Optional[torch.Tensor], key, style_mixing_prob: float
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    k_mix, k_noise = key.split(2)
    ws = run_mapping_with_mixing(g_cfg, g_params, z, c, k_mix,
                                 style_mixing_prob)
    img = sg2.synthesis_apply(g_cfg.synthesis, g_params["synthesis"], ws,
                              noise_mode="random", generator=k_noise)
    return img, ws


def run_D(d_cfg: sg2.DiscriminatorConfig, d_params: Params,
          img: torch.Tensor, c: Optional[torch.Tensor],
          augment_fn: AugmentFn, ada_p, key) -> torch.Tensor:
    if augment_fn is not None:
        img = augment_fn(img, ada_p, key)
    return sg2.discriminator_apply(d_cfg, d_params, img, c)


def g_main_loss(cfg: GANLossConfig, g_cfg: sg2.GeneratorConfig,
                d_cfg: sg2.DiscriminatorConfig, g_params: Params,
                d_params: Params, z: torch.Tensor, c: Optional[torch.Tensor],
                key, augment_fn: AugmentFn = None, ada_p=None):
    """Gmain: maximize D's logits on fakes."""
    k_g, k_aug = key.split(2)
    gen_img, gen_ws = run_G(g_cfg, g_params, z, c, k_g, cfg.style_mixing_prob)
    gen_logits = run_D(d_cfg, d_params, gen_img, c, augment_fn, ada_p, k_aug)
    loss = softplus(-gen_logits).mean()
    metrics = {
        "Loss/scores/fake": gen_logits.mean(),
        "Loss/signs/fake": torch.sign(gen_logits).mean(),
        "Loss/G/loss": loss,
        # Batch-mean w for the trainer's w_avg update.
        "aux/mean_w": gen_ws[:, 0].float().mean(dim=0),
    }
    return loss, _detached(metrics)


def g_pl_loss(cfg: GANLossConfig, g_cfg: sg2.GeneratorConfig,
              g_params: Params, z: torch.Tensor, c: Optional[torch.Tensor],
              key, pl_mean: torch.Tensor):
    """Greg: path-length regularization.  ``metrics['aux/pl_mean']`` is the
    updated moving average (the trainer stores it)."""
    batch = z.shape[0] // cfg.pl_batch_shrink
    z = z[:batch]
    if c is not None:
        c = c[:batch]
    k_mix, k_noise, k_pl = key.split(3)
    ws = run_mapping_with_mixing(g_cfg, g_params, z, c, k_mix,
                                 cfg.style_mixing_prob)
    img = sg2.synthesis_apply(g_cfg.synthesis, g_params["synthesis"], ws,
                              noise_mode="random", generator=k_noise)
    pl_noise = k_pl.normal(img.shape, device=img.device).to(img.dtype) / (
        np.sqrt(img.shape[2] * img.shape[3]))
    # d/dws sum(img * noise): one VJP through the synthesis network, kept
    # in the graph so that the penalty differentiates through it.
    (pl_grads,) = torch.autograd.grad((img * pl_noise).sum(), ws,
                                      create_graph=True)
    pl_lengths = pl_grads.square().sum(dim=2).mean(dim=1).sqrt()
    new_pl_mean = (pl_mean + cfg.pl_decay * (pl_lengths.mean() - pl_mean)
                   ).detach()
    pl_penalty = (pl_lengths - new_pl_mean).square()
    loss = pl_penalty.mean() * cfg.pl_weight
    metrics = {
        "Loss/pl_penalty": pl_penalty.mean(),
        "Loss/G/reg": loss,
        "aux/pl_mean": new_pl_mean,
    }
    return loss, _detached(metrics)


def _ga_refine_fakes(g_cfg, d_cfg, g_params, d_params, real_img, gen_img,
                     gen_ws, key, ga_threshold: float,
                     ga_mutation_rate: float):
    """GA refinement of near-boundary fakes before D scores them: fakes
    whose |D(real) - D(fake)| < threshold are replaced by crossed and
    mutated offspring regenerated through G.  A data transformation outside
    autograd (the refinement runs under no_grad)."""
    from ..ga.refine import apply_genetic_refinement

    refined, mask = apply_genetic_refinement(
        g_cfg, g_params, d_cfg, d_params, real_img, gen_img, gen_ws, key,
        threshold=ga_threshold, mutation_rate=ga_mutation_rate,
        return_mask=True)
    return refined, mask.float().mean()


def d_main_loss(cfg: GANLossConfig, g_cfg: sg2.GeneratorConfig,
                d_cfg: sg2.DiscriminatorConfig, g_params: Params,
                d_params: Params, real_img: torch.Tensor,
                real_c: Optional[torch.Tensor], z: torch.Tensor,
                gen_c: Optional[torch.Tensor], key,
                augment_fn: AugmentFn = None, ada_p=None,
                ga_threshold: Optional[float] = None,
                ga_mutation_rate: float = 0.1):
    """Dmain: minimize logits on fakes, maximize on reals; with
    ``ga_threshold`` set, near-boundary fakes are first replaced by GA
    offspring."""
    k_g, k_aug1, k_aug2, k_ga = key.split(4)
    with torch.no_grad():
        gen_img, gen_ws = run_G(g_cfg, g_params, z, gen_c, k_g,
                                cfg.style_mixing_prob)
    metrics: Dict[str, torch.Tensor] = {}
    if ga_threshold is not None:
        gen_img, replaced = _ga_refine_fakes(
            g_cfg, d_cfg, g_params, d_params, real_img, gen_img, gen_ws,
            k_ga, ga_threshold, ga_mutation_rate)
        metrics["Loss/ga/replaced"] = replaced
    gen_logits = run_D(d_cfg, d_params, gen_img, gen_c, augment_fn, ada_p,
                       k_aug1)
    loss_gen = softplus(gen_logits).mean()
    real_logits = run_D(d_cfg, d_params, real_img, real_c, augment_fn, ada_p,
                        k_aug2)
    loss_real = softplus(-real_logits).mean()
    metrics.update({
        "Loss/scores/fake": gen_logits.mean(),
        "Loss/signs/fake": torch.sign(gen_logits).mean(),
        "Loss/scores/real": real_logits.mean(),
        "Loss/signs/real": torch.sign(real_logits).mean(),
        "Loss/D/loss": loss_gen + loss_real,
    })
    return loss_gen + loss_real, _detached(metrics)


def gd_main_loss(cfg: GANLossConfig, g_cfg: sg2.GeneratorConfig,
                 d_cfg: sg2.DiscriminatorConfig, g_params: Params,
                 d_params: Params, real_img: torch.Tensor,
                 real_c: Optional[torch.Tensor], z: torch.Tensor,
                 gen_c: Optional[torch.Tensor], key,
                 augment_fn: AugmentFn = None, ada_p=None,
                 ga_threshold: Optional[float] = None,
                 ga_mutation_rate: float = 0.1):
    """Gmain + Dmain as one scalar over one G forward: loss_g sees detached
    D parameters and loss_d detached fakes, so one backward of the sum gives
    exactly the per-phase gradients.  The fake is augmented with one key on
    both routes (one augment draw per image, as in the JAX module).  JAX's
    compiler merges the two D(fake) forwards into one; eager torch runs both
    (the G route needs the image gradient, the D route the parameters')."""
    k_g, k_aug, k_ga = key.split(3)
    k_aug1, k_aug2 = k_aug.split(2)
    gen_img, gen_ws = run_G(g_cfg, g_params, z, gen_c, k_g,
                            cfg.style_mixing_prob)

    # G route: D with frozen parameters.
    d_frozen = sg2.tree_map(torch.Tensor.detach, d_params)
    gen_logits_g = run_D(d_cfg, d_frozen, gen_img, gen_c, augment_fn, ada_p,
                         k_aug1)
    loss_g = softplus(-gen_logits_g).mean()

    # D route: the same fake, detached (or its GA-refined replacement).
    gen_img_d = gen_img.detach()
    metrics: Dict[str, torch.Tensor] = {}
    if ga_threshold is not None:
        gen_img_d, replaced = _ga_refine_fakes(
            g_cfg, d_cfg, g_params, d_params, real_img, gen_img_d, gen_ws,
            k_ga, ga_threshold, ga_mutation_rate)
        metrics["Loss/ga/replaced"] = replaced
    gen_logits_d = run_D(d_cfg, d_params, gen_img_d, gen_c, augment_fn, ada_p,
                         k_aug1)
    real_logits = run_D(d_cfg, d_params, real_img, real_c, augment_fn, ada_p,
                        k_aug2)
    loss_d = softplus(gen_logits_d).mean() + softplus(-real_logits).mean()
    metrics.update({
        "Loss/scores/fake": gen_logits_d.mean(),
        "Loss/signs/fake": torch.sign(gen_logits_d).mean(),
        "Loss/scores/real": real_logits.mean(),
        "Loss/signs/real": torch.sign(real_logits).mean(),
        "Loss/G/loss": loss_g,
        "Loss/D/loss": loss_d,
        "aux/mean_w": gen_ws[:, 0].float().mean(dim=0),
    })
    return loss_g + loss_d, _detached(metrics)


def d_r1_loss(cfg: GANLossConfig, d_cfg: sg2.DiscriminatorConfig,
              d_params: Params, real_img: torch.Tensor,
              real_c: Optional[torch.Tensor], key,
              augment_fn: AugmentFn = None, ada_p=None):
    """Dreg: R1 gradient penalty on reals, through the augment pipe."""
    img = real_img.detach().requires_grad_(True)
    logits = run_D(d_cfg, d_params, img, real_c, augment_fn, ada_p, key)
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
