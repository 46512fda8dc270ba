"""Improved Precision & Recall (port of
gagan_tpu/metrics/precision_recall.py): pairwise squared distances on the
device in row batches, the k-th neighbour by ``np.partition`` on the host."""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import feature_stats as fs


def _pairwise_dist(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Squared distances by the expansion |r|^2 - 2 r.c + |c|^2, clamped
    at 0 (rounding can take a distance of 0 below it)."""
    r2 = row.square().sum(dim=1, keepdim=True)
    c2 = col.square().sum(dim=1, keepdim=True)
    return torch.clamp_min(r2 - 2 * (row @ col.T) + c2.T, 0)


def knn_precision_recall(real_features: np.ndarray,
                         gen_features: np.ndarray,
                         nhood_size: int = 3,
                         row_batch_size: int = 10000,
                         device="cuda") -> tuple:
    device = resolve_device(device)
    results = {}
    with torch.no_grad():
        for name, manifold, probes in [
            ("precision", real_features, gen_features),
            ("recall", gen_features, real_features),
        ]:
            manifold_t = torch.as_tensor(np.asarray(manifold, np.float32),
                                         device=device)
            kth = []
            for start in range(0, manifold.shape[0], row_batch_size):
                batch = manifold_t[start: start + row_batch_size]
                d = _pairwise_dist(batch, manifold_t).cpu().numpy()
                kth.append(np.partition(d, nhood_size, axis=1)[:, nhood_size])
            kth = np.concatenate(kth)
            pred = []
            for start in range(0, probes.shape[0], row_batch_size):
                batch = torch.as_tensor(np.asarray(
                    probes[start: start + row_batch_size], np.float32),
                    device=device)
                d = _pairwise_dist(batch, manifold_t).cpu().numpy()
                pred.append((d <= kth[None, :]).any(axis=1))
            results[name] = float(np.concatenate(pred).mean())
    return results["precision"], results["recall"]


def compute_pr(opts: fs.MetricOptions, max_real, num_gen, nhood_size: int = 3,
               detector_name: str = "vgg16") -> tuple:
    real = fs.compute_feature_stats_for_dataset(
        opts, detector_name, capture_all=True, max_items=max_real).get_all()
    gen = fs.compute_feature_stats_for_generator(
        opts, detector_name, capture_all=True, max_items=num_gen).get_all()
    return knn_precision_recall(real, gen, nhood_size=nhood_size,
                                device=opts.device)
