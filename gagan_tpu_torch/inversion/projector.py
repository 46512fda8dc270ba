"""LPIPS latent projection (port of gagan_tpu/inversion/projector.py).

Optimisation-based inversion of one image: Adam over a latent (w or z
space) and the generator's per-layer noise buffers, with a cosine learning
rate ramp, annealed latent noise, the multi-scale noise autocorrelation
penalty and the noise buffers renormalised after every step.  The
generator's weights stay constants: only the latent and the noise buffers
take gradients, so the fused modconv level's backward is asked for dx,
d(styles), d(dcoefs) and d(noise), never for dW.

Random draws come from ``rng`` (utils/rng.py ``Rng`` or an object with its
methods, e.g. one backed by ``jax.random`` in tests): the i-th noise
buffer from ``rng.fold_in(i)``, each step's latent noise from a key split
off ``rng``, as the JAX function draws them.  The latent statistics draw
from ``np.random.RandomState(123)``, as there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import stylegan2 as sg2
from ..train.train_step import Adam
from ..utils.rng import Rng


def _area_resize_256(img: torch.Tensor) -> torch.Tensor:
    """F.interpolate(mode='area') to 256 for an integer factor: a mean
    pool."""
    h = img.shape[2]
    if h <= 256:
        return img
    return F.avg_pool2d(img, h // 256)


def noise_regularization(noise_bufs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The multi-scale autocorrelation penalty over [H, W] buffers."""
    reg = 0.0
    for v in noise_bufs.values():
        noise = v[None, None]
        while True:
            reg = reg + (noise * torch.roll(noise, 1, dims=3)).mean().square()
            reg = reg + (noise * torch.roll(noise, 1, dims=2)).mean().square()
            if noise.shape[2] <= 8:
                break
            noise = F.avg_pool2d(noise, 2)
    return reg


def collect_noise_bufs(synthesis_params) -> Dict[str, torch.Tensor]:
    """{"block.layer": noise_const} in the parameter tree's order."""
    return {f"{bname}.{lname}": layer["noise_const"]
            for bname, block in synthesis_params.items()
            for lname, layer in block.items()
            if isinstance(layer, dict) and "noise_const" in layer}


def _with_noise_bufs(synthesis_params, noise_bufs):
    """A shallow copy of the synthesis tree with the noise buffers
    replaced."""
    out = {b: dict(block) for b, block in synthesis_params.items()}
    for key, buf in noise_bufs.items():
        bname, lname = key.split(".")
        out[bname][lname] = {**out[bname][lname], "noise_const": buf}
    return out


def _default_lpips_fn(device):
    from ..metrics import detectors

    return detectors.make_default("vgg16_lpips", device)


def project(
    g_cfg: sg2.GeneratorConfig,
    g_params,
    target,                             # [C, H, W] uint8 in [0, 255]
    num_steps: int = 1000,
    w_avg_samples: int = 10000,
    initial_learning_rate: float = 0.1,
    initial_noise_factor: float = 0.05,
    lr_rampdown_length: float = 0.25,
    lr_rampup_length: float = 0.05,
    noise_ramp_length: float = 0.75,
    regularize_noise_weight: float = 1e5,
    space: str = "w",
    truncation_psi: float = 1.0,
    lpips_fn: Optional[Callable] = None,
    rng=None,
    verbose: bool = False,
    return_trajectory: bool = False,
    hooks=None,
    on_step: Optional[Callable[[int, torch.Tensor, Dict[str, torch.Tensor]],
                               None]] = None,
):
    """Projected W+ latents [num_ws, w_dim] as numpy (with
    ``return_trajectory``: (the latents after each step [num_steps, ...],
    the W+ latents)).  Runs on the device of ``g_params``.  ``on_step``,
    when given, is called after each step with the step's index, its LPIPS
    distance (a device scalar: no host read) and the gradients Adam took
    ({"latent": ..., "noise.<layer>": ...})."""
    assert space in ("w", "z")
    device = g_params["mapping"]["fc0"]["weight"].device
    rng = rng if rng is not None else Rng(0)
    lpips = lpips_fn or _default_lpips_fn(device)

    target_images = torch.as_tensor(np.asarray(target), dtype=torch.float32,
                                    device=device)[None]
    with torch.no_grad():
        target_features = lpips(_area_resize_256(target_images))

    # Latent statistics.
    if space == "w":
        z_samples = np.random.RandomState(123).randn(w_avg_samples,
                                                     g_cfg.z_dim)
        with torch.no_grad():
            w_samples = sg2.mapping_apply(
                g_cfg.mapping, g_params["mapping"],
                torch.as_tensor(z_samples, dtype=torch.float32, device=device),
                truncation_psi=truncation_psi)
        w_samples = w_samples[:, :1].cpu().numpy()
        latent_avg = np.mean(w_samples, axis=0, keepdims=True)
        latent_std = float(np.sum((w_samples - latent_avg) ** 2)
                           / w_avg_samples) ** 0.5
        latent = torch.as_tensor(latent_avg[:, 0], device=device)   # [1, C]
    else:
        latent_std = 1.0
        latent = torch.zeros((1, g_cfg.z_dim), device=device)

    noise_bufs = {k: rng.fold_in(i).normal(tuple(v.shape), device).to(device)
                  for i, (k, v) in enumerate(collect_noise_bufs(
                      g_params["synthesis"]).items())}
    opt_vars = {"latent": latent.clone(), "noise": noise_bufs}
    tx = Adam(1.0, 0.9, 0.999, 1e-8)          # lr set per step
    opt_state = tx.init(opt_vars)

    def synth(latent, noise_bufs):
        syn_params = _with_noise_bufs(g_params["synthesis"], noise_bufs)
        if space == "w":
            ws = latent[:, None, :].expand(-1, g_cfg.num_ws, -1)
        else:
            ws = sg2.mapping_apply(g_cfg.mapping, g_params["mapping"],
                                   latent, truncation_psi=truncation_psi)
        return sg2.synthesis_apply(g_cfg.synthesis, syn_params, ws,
                                   noise_mode="const", hooks=hooks)

    leaves = [opt_vars["latent"]] + list(opt_vars["noise"].values())
    trajectory = []
    for step in range(num_steps):
        t = step / num_steps
        noise_scale = (latent_std * initial_noise_factor
                       * max(0.0, 1.0 - t / noise_ramp_length) ** 2)
        lr_ramp = min(1.0, (1.0 - t) / lr_rampdown_length)
        lr_ramp = 0.5 - 0.5 * np.cos(lr_ramp * np.pi)
        lr_ramp = lr_ramp * min(1.0, t / lr_rampup_length)
        lr = initial_learning_rate * lr_ramp
        rng, k_step = rng.split(2)

        for v in leaves:
            v.requires_grad_(True)
        latent_noise = k_step.normal(tuple(latent.shape), device).to(device)
        img = synth(opt_vars["latent"] + latent_noise * np.float32(
            noise_scale), opt_vars["noise"])
        img = _area_resize_256((img.float() + 1) * (255 / 2))
        dist = (target_features - lpips(img)).square().sum()
        reg = noise_regularization(opt_vars["noise"])
        loss = dist + reg * regularize_noise_weight
        grads = torch.autograd.grad(loss, leaves)
        for v in leaves:
            v.requires_grad_(False)
        grads = {"latent": grads[0],
                 **{f"noise.{k}": g for k, g in zip(opt_vars["noise"],
                                                    grads[1:])}}
        dataclasses.replace(tx, lr=float(np.float32(lr))).update_(
            grads, opt_state, opt_vars)
        with torch.no_grad():             # renormalise the noise buffers
            for v in opt_vars["noise"].values():
                v.copy_((v - v.mean()) * torch.rsqrt(v.square().mean()))
        if on_step is not None:
            on_step(step, dist.detach(), grads)
        if verbose and (step + 1) % 50 == 0:
            print(f"step {step + 1:>4d}/{num_steps}: dist {float(dist):.3f} "
                  f"loss {float(loss):.3f}")
        if return_trajectory:
            trajectory.append(opt_vars["latent"][0].cpu().numpy().copy())

    final = opt_vars["latent"]
    with torch.no_grad():
        if space == "z":
            final = sg2.mapping_apply(g_cfg.mapping, g_params["mapping"],
                                      final, truncation_psi=truncation_psi)[0]
        else:
            final = final[:, None, :].expand(-1, g_cfg.num_ws, -1)[0]
    final = final.cpu().numpy()
    if return_trajectory:
        return np.stack(trajectory), final
    return final
