"""e4e encoder training's latent-space adversary (port of
gagan_tpu/inversion/e4e_training.py): the w-code discriminator, its
losses with R1, and the 50% replay pool of past codes.

The discriminator is an MLP of ``n_mlp`` linear layers with LeakyReLU(0.2)
between them, its parameters named as the reference's torch Sequential
(``mlp.{0,2,4,6}``), so torch checkpoints convert one to one.  Random
weights are drawn from ``rng`` (``utils/rng.py::Rng`` or an object with its
methods): layer ``i`` of the Sequential from ``rng.fold_in(i)``.  The pool
draws from ``np.random.RandomState(seed)`` on the host, as the JAX class
does, so the two return equal codes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Dict[str, torch.Tensor]]


def init_latent_discriminator(rng, style_dim: int = 512, n_mlp: int = 4,
                              device="cpu") -> Params:
    """Weights N(0, 1/style_dim), zero biases; the last layer has one
    output."""
    params: Params = {}
    for layer in range(n_mlp):
        idx = 2 * layer       # the LeakyReLUs take the odd slots
        out = 1 if layer == n_mlp - 1 else style_dim
        w = rng.fold_in(idx).normal((out, style_dim), device)
        params[f"mlp.{idx}"] = {
            "weight": (w / np.sqrt(style_dim)).to(device),
            "bias": torch.zeros((out,), device=device)}
    return params


def latent_discriminator_apply(params: Params, w: torch.Tensor) -> torch.Tensor:
    """D(w): [N, style_dim] (or [N, L, style_dim]) -> [N(, L), 1]."""
    layers = sorted(params, key=lambda n: int(n.split(".")[1]))
    x = w
    for i, name in enumerate(layers):
        x = x @ params[name]["weight"].t() + params[name]["bias"]
        if i < len(layers) - 1:
            x = F.leaky_relu(x, 0.2)
    return x


def d_logistic_loss(real_pred: torch.Tensor,
                    fake_pred: torch.Tensor) -> torch.Tensor:
    """The non-saturating logistic loss of D."""
    return (F.softplus(-real_pred) + F.softplus(fake_pred)).mean()


def g_nonsaturating_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    return F.softplus(-fake_pred).mean()


def d_r1_loss(params: Params, real_w: torch.Tensor) -> torch.Tensor:
    """R1 penalty on real codes: the mean over the batch of |dD/dw|^2,
    differentiable in D's parameters (and in ``real_w`` when it requires
    grad)."""
    if not real_w.requires_grad:
        real_w = real_w.detach().requires_grad_(True)
    score = latent_discriminator_apply(params, real_w).sum()
    (grad,) = torch.autograd.grad(score, [real_w], create_graph=True)
    return grad.square().sum() / real_w.shape[0]


class LatentCodesPool:
    """A 50%-replay buffer of past w codes, on the host with its own numpy
    RNG (the reference uses Python's global ``random``)."""

    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.rng = np.random.RandomState(seed)
        self.ws: List[np.ndarray] = []

    def query(self, ws) -> np.ndarray:
        """Codes [N, dim] (or [N, n_latent, dim]: one random layer's code
        each) -> [N, dim], each the code given or, half of the time once
        the pool is full, a pooled one that it replaces."""
        if isinstance(ws, torch.Tensor):
            ws = ws.detach().cpu().numpy()
        if self.pool_size == 0:
            return np.asarray(ws)
        out = []
        for w in np.asarray(ws):
            if w.ndim == 2:
                w = w[self.rng.randint(0, len(w))]
            out.append(self._handle(w))
        return np.stack(out, 0)

    def _handle(self, w: np.ndarray) -> np.ndarray:
        if len(self.ws) < self.pool_size:
            self.ws.append(w)
            return w
        if self.rng.uniform() > 0.5:
            idx = self.rng.randint(0, self.pool_size)
            old = self.ws[idx].copy()
            self.ws[idx] = w
            return old
        return w
