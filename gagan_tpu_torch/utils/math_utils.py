"""Embedding-space resampling under a cosine bound, and convex hulls
(port of gagan_tpu/utils/math_utils.py).

The samplers take a draw source (``rng``: an
:class:`~gagan_tpu_torch.utils.rng.Rng`, or any object with its ``split``
and ``uniform``), where the JAX functions take a key: the same split, so
a test can hand in JAX's draws.
"""

from __future__ import annotations

import torch


def _resample(rng, u_unit: torch.Tensor,
              cos_lower_bound: float) -> torch.Tensor:
    """A random direction perpendicular to each row and a cosine uniform
    in [cos_lower_bound, 1]."""
    n, dim = u_unit.shape
    k_r, k_c = rng.split(2)
    r = k_r.uniform((n, dim), device=u_unit.device) * 2.0 - 1.0
    proj = (r * u_unit).sum(dim=1, keepdim=True)
    uperp = r - proj * u_unit
    uperp = uperp / uperp.norm(dim=1, keepdim=True)
    cos_theta = (k_c.uniform((n, 1), device=u_unit.device)
                 * (1.0 - cos_lower_bound) + cos_lower_bound)
    return cos_theta * u_unit + torch.sqrt(1.0 - cos_theta**2) * uperp


def resample_single_vector(rng, target_vector: torch.Tensor,
                           cos_lower_bound: float,
                           n_vectors: int = 1) -> torch.Tensor:
    """``n_vectors`` unit vectors with cos(v, target) >= cos_lower_bound;
    target: [dim] or [1, dim]."""
    if target_vector.ndim == 1:
        target_vector = target_vector[None]
    u = target_vector / target_vector.norm(dim=-1, keepdim=True)
    u = u.expand(n_vectors, u.shape[-1])
    return _resample(rng, u, cos_lower_bound)


def resample_batch_vectors(rng, target_vectors: torch.Tensor,
                           cos_lower_bound: float) -> torch.Tensor:
    """Per-row resampling of a [b, dim] batch."""
    u = target_vectors / target_vectors.norm(dim=-1, keepdim=True)
    return _resample(rng, u, cos_lower_bound)


def resample_batch_templated_embeddings(rng, embeddings: torch.Tensor,
                                        cos_lower_bound: float
                                        ) -> torch.Tensor:
    """[b, templates, dim] (or [b, dim]) variant."""
    if embeddings.ndim == 2:
        return resample_batch_vectors(rng, embeddings, cos_lower_bound)
    b, t, d = embeddings.shape
    flat = resample_batch_vectors(rng, embeddings.reshape(b * t, d),
                                  cos_lower_bound)
    return flat.reshape(b, t, d)


def convex_hull(target_vectors: torch.Tensor,
                alphas: torch.Tensor) -> torch.Tensor:
    """Normalized convex combinations of [b, d1, d2] vector sets with mixing
    weights [m, b]."""
    out = torch.einsum("mb,bij->mij", alphas, target_vectors)
    return out / out.norm(dim=-1, keepdim=True)


def convex_hull_small(target_vectors: torch.Tensor,
                      alphas: torch.Tensor) -> torch.Tensor:
    """[b, dim] variant of :func:`convex_hull`."""
    out = alphas @ target_vectors
    return out / out.norm(dim=-1, keepdim=True)
