"""Inception Score (port of gagan_tpu/metrics/inception_score.py)."""

from __future__ import annotations

import numpy as np

from . import feature_stats as fs


def is_from_probs(gen_probs: np.ndarray, num_splits: int = 10):
    num_gen = gen_probs.shape[0]
    scores = []
    for i in range(num_splits):
        part = gen_probs[i * num_gen // num_splits:
                         (i + 1) * num_gen // num_splits]
        kl = part * (np.log(part) - np.log(np.mean(part, axis=0,
                                                   keepdims=True)))
        kl = np.mean(np.sum(kl, axis=1))
        scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))


def compute_is(opts: fs.MetricOptions, num_gen: int, num_splits: int = 10,
               detector_name: str = "inception_softmax"):
    gen_probs = fs.compute_feature_stats_for_generator(
        opts, detector_name, capture_all=True, max_items=num_gen).get_all()
    return is_from_probs(gen_probs, num_splits)
