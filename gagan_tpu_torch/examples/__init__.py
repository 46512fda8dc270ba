"""The JAX package's five examples on the port (``examples/*.py``), each
run as ``python -m gagan_tpu_torch.examples.<name>`` with the JAX script's
flags plus ``--device`` (CUDA unless ``--device cpu``):

* ``quick_start``: a paper grid of 16 seeds;
* ``editing``: an InterFaceGAN sweep and a StyleSpace channel edit;
* ``adaptation_inference``: (source, adapted) pairs of an adaptation;
* ``morphing``: scaled and blended offsets of one or more adaptations;
* ``pruned_forward``: a StyleSpace direction at several sparsities.

They write PNGs with ``utils/png.py`` (no Pillow) and read snapshots and
adaptation checkpoints with ``utils/checkpoint.py``.  Each ``main(argv)``
returns the paths it wrote.  The latents the JAX scripts draw from
``jax.random`` come from :func:`draw_latents` here, the one place a test
replaces to hand in JAX's draws.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch

from ..utils import png
from ..utils.image_utils import t2im
from ..utils.rng import Rng


def draw_latents(seed: int, n: int, z_dim: int, device) -> torch.Tensor:
    """Standard normal latents [n, z_dim] of ``seed`` (the JAX scripts'
    ``jax.random.normal(PRNGKey(seed), ...)``; torch cannot draw JAX's
    numbers)."""
    return Rng(seed).normal((n, z_dim), device=device)


def numpy_latents(seeds: Sequence[int], z_dim: int, device) -> torch.Tensor:
    """One ``np.random.RandomState(seed).randn(z_dim)`` row a seed, as the
    JAX scripts draw them (the same numbers in both packages)."""
    return torch.as_tensor(np.stack([np.random.RandomState(s).randn(z_dim)
                                     for s in seeds]),
                           dtype=torch.float32, device=device)


def image_row(imgs, size: int = 256) -> np.ndarray:
    """NCHW images in [-1, 1] side by side as one HWC uint8 row."""
    return np.concatenate([t2im(im, size=size) for im in imgs], axis=1)


def save(path: str, img: np.ndarray, written: List[str]) -> None:
    png.write_png(path, img)
    written.append(path)


def outdir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
