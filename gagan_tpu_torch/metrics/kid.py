"""Kernel Inception Distance (port of gagan_tpu/metrics/kid.py).  The
subsets are drawn with ``np.random.RandomState(seed)``, as in the JAX
module, so the two packages give equal values on equal features."""

from __future__ import annotations

import numpy as np

from . import feature_stats as fs


def kid_from_features(real_features: np.ndarray, gen_features: np.ndarray,
                      num_subsets: int, max_subset_size: int,
                      seed: int = 0) -> float:
    n = real_features.shape[1]
    m = min(min(real_features.shape[0], gen_features.shape[0]),
            max_subset_size)
    rnd = np.random.RandomState(seed)
    t = 0.0
    for _ in range(num_subsets):
        x = gen_features[rnd.choice(gen_features.shape[0], m, replace=False)]
        y = real_features[rnd.choice(real_features.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.diag(a).sum()) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def compute_kid(opts: fs.MetricOptions, max_real, num_gen,
                num_subsets: int = 100, max_subset_size: int = 1000,
                detector_name: str = "inception") -> float:
    real = fs.compute_feature_stats_for_dataset(
        opts, detector_name, capture_all=True, max_items=max_real).get_all()
    gen = fs.compute_feature_stats_for_generator(
        opts, detector_name, capture_all=True, max_items=num_gen).get_all()
    return kid_from_features(real, gen, num_subsets, max_subset_size,
                             seed=opts.rng_seed)
