"""In-training GA refinement of near-boundary fakes (port of
gagan_tpu/ga/refine.py).

Fakes whose discriminator scores are within ``threshold`` of the paired
real's are replaced by offspring: the fake's W+ latents crossed with the
mapping of a fresh z (or an encoder's latents of the real), mutated, and
regenerated through the synthesis network.  The replacement is a
fixed-shape ``torch.where`` select, as in the JAX module.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models import stylegan2 as sg2
from .crossover_mutation import dynamic_mutation, gaussian_crossover

Params = Dict


def wgan_gradient_penalty(
    d_cfg: sg2.DiscriminatorConfig,
    d_params: Params,
    real_img: torch.Tensor,
    fake_img: torch.Tensor,
    key,
    c: Optional[torch.Tensor] = None,
    critic_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """WGAN-GP penalty on real/fake interpolates: per-sample alpha ~
    U[0,1), x_hat = alpha*real + (1-alpha)*fake, mean((||dD/dx_hat|| - 1)^2).
    Differentiable in the discriminator's parameters (create_graph)."""
    alpha = key.uniform((real_img.shape[0], 1, 1, 1),
                        device=real_img.device).to(real_img.dtype)
    interp = (alpha * real_img + (1.0 - alpha) * fake_img).detach()
    interp.requires_grad_(True)
    if critic_fn is not None:
        scores = critic_fn(interp)
    else:
        scores = sg2.discriminator_apply(d_cfg, d_params, interp, c=c)
    (grads,) = torch.autograd.grad(scores.sum(), interp, create_graph=True)
    norms = torch.sqrt(grads.reshape(grads.shape[0], -1).square().sum(dim=1)
                       + 1e-12)
    return (norms - 1.0).square().mean()


def apply_genetic_refinement(
    g_cfg: sg2.GeneratorConfig,
    g_params: Params,
    d_cfg: sg2.DiscriminatorConfig,
    d_params: Params,
    real_img: torch.Tensor,
    fake_img: torch.Tensor,
    fake_ws: torch.Tensor,            # [N, num_ws, w_dim] latents of the fakes
    key,
    threshold: float = 0.5,
    mutation_rate: float = 0.1,
    encoder_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    hooks: Optional[sg2.LayerHooks] = None,
    return_mask: bool = False,
    shard=None,
    d_constraint=None,
):
    """Fakes with near-boundary samples replaced by GA offspring (and, with
    ``return_mask``, the [N] replacement mask).  Runs under no_grad: the
    refinement is a data transformation outside autograd.  ``shard``: the
    images are a rank's share of the batch (``parallel.mesh.BatchShard``),
    which D's minibatch stddev reads whole.  ``d_constraint`` forwards to
    discriminator_apply's ``spatial_constraint`` (the step runs spatially
    sharded)."""
    with torch.no_grad():
        d_real = sg2.discriminator_apply(
            d_cfg, d_params, real_img, shard=shard,
            spatial_constraint=d_constraint)[:, 0]
        d_fake = sg2.discriminator_apply(
            d_cfg, d_params, fake_img, shard=shard,
            spatial_constraint=d_constraint)[:, 0]
        mask = (d_real - d_fake).abs() < threshold             # [N]

        k_enc, k_cx, k_mut, k_noise = key.split(4)
        if encoder_fn is not None:
            real_latents = encoder_fn(real_img)
        else:
            # No encoder: cross with the mapping of a fresh z.
            z2 = k_enc.normal((fake_ws.shape[0], g_cfg.z_dim),
                              device=fake_ws.device)
            real_latents = sg2.mapping_apply(g_cfg.mapping,
                                             g_params["mapping"], z2)
        children = gaussian_crossover(k_cx, real_latents, fake_ws)
        children = dynamic_mutation(k_mut, children, mutation_rate)
        new_imgs = sg2.synthesis_apply(g_cfg.synthesis, g_params["synthesis"],
                                       children, noise_mode="random",
                                       generator=k_noise, hooks=hooks)
        out = torch.where(mask[:, None, None, None], new_imgs, fake_img)
    if return_mask:
        return out, mask
    return out
