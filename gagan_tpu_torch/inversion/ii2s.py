"""II2S inversion (port of gagan_tpu/inversion/ii2s.py): per-layer W+
optimisation with a PCA prior.

Adam over W+ latents that start at the mapping's mean w; the loss is the
L2 distance at full resolution, the LPIPS distance of 256^2 cubic
downsamples, and the p-norm of the LeakyReLU(5)-mapped latents in a PCA
basis fitted on mapped samples.  The generator is frozen and its noise
buffers are constants, so the fused level's backward is asked for dx,
d(styles) and d(dcoefs) only.

Random draws come from ``rng`` (``utils/rng.py::Rng`` or an object with its
methods): the PCA's i-th batch of latents from ``rng.fold_in(i)``, the
w_avg estimate of an untrained mapping from ``rng`` itself, as the JAX
function draws them from its key.  The SVD runs in numpy on the host.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models import stylegan2 as sg2
from ..ops.resize import resize2d
from ..train.train_step import Adam
from ..utils.rng import Rng


@dataclasses.dataclass(frozen=True)
class II2SConfig:
    steps: int = 1300
    learning_rate: float = 0.01
    l2_lambda: float = 1.0
    percept_lambda: float = 1.0
    p_norm_lambda: float = 1e-3
    pca_samples: int = 100_000          # the reference fits 1M


def leaky5(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with negative slope 5 (the PULSE latent-space trick)."""
    return torch.where(x >= 0, x, 5.0 * x)


def mapped_samples(g_cfg: sg2.GeneratorConfig, g_params, rng,
                   n_samples: int = 100_000, batch: int = 65536
                   ) -> np.ndarray:
    """leaky5(mapping(z)) [n_samples, w_dim] on the host, the i-th batch of
    z drawn from ``rng.fold_in(i)`` on the mapping's device."""
    device = g_params["mapping"]["fc0"]["weight"].device
    samples, done, i = [], 0, 0
    while done < n_samples:
        n = min(batch, n_samples - done)
        z = rng.fold_in(i).normal((n, g_cfg.z_dim), device).to(device)
        with torch.no_grad():
            w = sg2.mapping_apply(g_cfg.mapping, g_params["mapping"], z,
                                  broadcast=False)
        samples.append(leaky5(w).cpu().numpy())
        done += n
        i += 1
    return np.concatenate(samples)


def pca_of(X: np.ndarray) -> Dict[str, np.ndarray]:
    """The exact PCA of the rows of ``X`` by SVD: X_mean [D], X_comp [k, D],
    X_stdev [k]."""
    X_mean = X.mean(axis=0)
    _, s, vt = np.linalg.svd(X - X_mean, full_matrices=False)
    return {"X_mean": X_mean, "X_comp": vt,
            "X_stdev": s / np.sqrt(X.shape[0] - 1)}


def build_pca_model(g_cfg: sg2.GeneratorConfig, g_params, rng,
                    n_samples: int = 100_000,
                    batch: int = 65536) -> Dict[str, np.ndarray]:
    """PCA of leaky5(mapping(z)) over ``n_samples`` draws (an exact SVD in
    place of the reference's incremental PCA)."""
    return pca_of(mapped_samples(g_cfg, g_params, rng, n_samples, batch))


def p_norm_loss(pca: Dict, latent_in: torch.Tensor,
                p_norm_lambda: float) -> torch.Tensor:
    """The mean square of the mapped latents' PCA coordinates, weighted."""
    dev = latent_in.device
    lat = leaky5(latent_in) - torch.as_tensor(pca["X_mean"], device=dev)
    proj = (lat @ torch.as_tensor(pca["X_comp"], device=dev).t()
            / torch.as_tensor(pca["X_stdev"], device=dev))
    return p_norm_lambda * proj.square().mean()


def bicubic_256(img: torch.Tensor) -> torch.Tensor:
    """Resize to 256^2 as jax.image.resize "cubic" (antialiased)."""
    if img.shape[2] == 256:
        return img
    return resize2d(img, (256, 256), "cubic", antialias=True)


def _default_lpips_fn(device):
    from ..metrics import detectors

    det = detectors.make_default("vgg16_lpips", device)
    if det.name.endswith("-random"):
        warnings.warn("II2S: VGG16-LPIPS has random weights (no vgg16.npz in "
                      "GAGAN_DETECTOR_DIR); the perceptual term is not LPIPS")
    return det


def make_loss(cfg: II2SConfig, g_cfg: sg2.GeneratorConfig, g_params,
              image_high: torch.Tensor, lpips_fn: Callable, pca: Dict):
    """``loss_fn(latent) -> (total, (l2, percep, p_norm))`` for W+ latents
    [1, num_ws, w_dim] against ``image_high`` [1, C, H, W] in [-1, 1]."""
    with torch.no_grad():
        ref_l_feats = lpips_fn((bicubic_256(image_high) + 1) * 127.5)

    def loss_fn(latent):
        img = sg2.synthesis_apply(g_cfg.synthesis, g_params["synthesis"],
                                  latent, noise_mode="const")
        l2 = (img - image_high).square().mean()
        gen_feats = lpips_fn((bicubic_256(img) + 1) * 127.5)
        percep = (gen_feats - ref_l_feats).square().sum()
        pn = p_norm_loss(pca, latent, cfg.p_norm_lambda)
        total = cfg.l2_lambda * l2 + cfg.percept_lambda * percep + pn
        return total, (l2, percep, pn)

    return loss_fn


def initial_latent(g_cfg: sg2.GeneratorConfig, g_params, rng) -> torch.Tensor:
    """W+ [1, num_ws, w_dim] at the mapping's w_avg, or, when w_avg is all
    zero (untrained), at the mean w of 4096 latents drawn from ``rng``."""
    w_avg = g_params["mapping"]["w_avg"]
    if float(w_avg.abs().sum()) == 0.0:
        z = rng.normal((4096, g_cfg.z_dim), w_avg.device).to(w_avg.device)
        with torch.no_grad():
            w_avg = sg2.mapping_apply(g_cfg.mapping, g_params["mapping"], z,
                                      broadcast=False).mean(dim=0)
    return w_avg[None, None].repeat(1, g_cfg.num_ws, 1)


def invert_image(
    cfg: II2SConfig,
    g_cfg: sg2.GeneratorConfig,
    g_params,
    image_high,                          # [C, H, W] float in [-1, 1]
    lpips_fn: Optional[Callable] = None,
    pca: Optional[Dict] = None,
    rng=None,
    verbose: bool = False,
) -> np.ndarray:
    """W+ latents [num_ws, w_dim] (numpy) of ``image_high``, after
    ``cfg.steps`` Adam steps on the device of ``g_params``.  ``lpips_fn``
    defaults to VGG16-LPIPS (``metrics/detectors.py``, warned when its
    weights are random); ``pca`` to :func:`build_pca_model` on
    ``min(cfg.pca_samples, 100_000)`` draws.  No host read inside a step,
    beside the ``verbose`` print every 100 steps."""
    device = g_params["mapping"]["fc0"]["weight"].device
    rng = rng if rng is not None else Rng(0)
    if pca is None:
        pca = build_pca_model(g_cfg, g_params, rng,
                              n_samples=min(cfg.pca_samples, 100_000))
    pca = {k: torch.as_tensor(v, device=device) for k, v in pca.items()}
    if lpips_fn is None:
        lpips_fn = _default_lpips_fn(device)
    ref_h = torch.as_tensor(np.asarray(image_high), dtype=torch.float32,
                            device=device)[None]
    loss_fn = make_loss(cfg, g_cfg, g_params, ref_h, lpips_fn, pca)

    opt = {"latent": initial_latent(g_cfg, g_params, rng)}
    tx = Adam(cfg.learning_rate, 0.9, 0.999, 1e-8)
    opt_state = tx.init(opt)
    for i in range(cfg.steps):
        latent = opt["latent"].requires_grad_(True)
        loss, (l2, percep, pn) = loss_fn(latent)
        (grad,) = torch.autograd.grad(loss, [latent])
        latent.requires_grad_(False)
        tx.update_({"latent": grad}, opt_state, opt)
        if verbose and (i + 1) % 100 == 0:
            print(f"II2S {i + 1}/{cfg.steps}: loss {float(loss):.4f} "
                  f"l2 {float(l2):.4f} percep {float(percep):.4f} "
                  f"p-norm {float(pn):.5f}")
    return opt["latent"][0].cpu().numpy()
