"""Frechet Inception Distance (port of gagan_tpu/metrics/fid.py): numpy and
``scipy.linalg.sqrtm`` on the feature statistics."""

from __future__ import annotations

import numpy as np
import scipy.linalg

from . import feature_stats as fs


def frechet_distance(mu_real, sigma_real, mu_gen, sigma_gen) -> float:
    m = np.square(mu_gen - mu_real).sum()
    # The principal root, as the JAX module's sqrtm(..., disp=False)[0]
    # (SciPy 1.18 drops ``disp``; without it every version returns the root).
    s = scipy.linalg.sqrtm(np.dot(sigma_gen, sigma_real))
    return float(np.real(m + np.trace(sigma_gen + sigma_real - s * 2)))


def compute_fid(opts: fs.MetricOptions, max_real, num_gen,
                detector_name: str = "inception") -> float:
    mu_real, sigma_real = fs.compute_feature_stats_for_dataset(
        opts, detector_name, capture_mean_cov=True,
        max_items=max_real).get_mean_cov()
    mu_gen, sigma_gen = fs.compute_feature_stats_for_generator(
        opts, detector_name, capture_mean_cov=True,
        max_items=num_gen).get_mean_cov()
    return frechet_distance(mu_real, sigma_real, mu_gen, sigma_gen)
