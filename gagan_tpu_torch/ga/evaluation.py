"""GA metrics (port of gagan_tpu/ga/evaluation.py): FID, KID and LPIPS
between a real and a generated batch, with the port's metric stack."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..metrics import fid as fid_lib
from ..metrics import kid as kid_lib


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def extract_features(images: torch.Tensor,
                     feature_fn: Optional[Callable] = None,
                     batch_size: int = 32, device="cuda") -> np.ndarray:
    """Features of [N, C, H, W] images in [-1, 1] in batches of
    ``batch_size``; ``feature_fn`` defaults to the random Swin-T extractor
    (models/swin.py, seed 0) on ``device``."""
    if feature_fn is None:
        from ..models import swin

        feature_fn = swin.make_feature_extractor(device=device)
    return np.concatenate([_numpy(feature_fn(images[i:i + batch_size]))
                           for i in range(0, images.shape[0], batch_size)])


def make_alex_lpips(params=None, gen: Optional[torch.Generator] = None,
                    device="cuda") -> Callable:
    """Pairwise LPIPS(net='alex') fn f(a, b) -> [N] for [-1, 1] NCHW
    images: ``params`` converted (metrics/alexnet.py), or random weights
    from ``gen`` (seed 0 without it) on ``device``."""
    from .. import resolve_device
    from ..metrics import alexnet

    if params is None:
        params = alexnet.init_alexnet_lpips(
            gen if gen is not None else torch.Generator().manual_seed(0),
            resolve_device(device))

    def distance(a, b):
        with torch.no_grad():
            return alexnet.lpips_distance(params, a, b)

    return distance


def calculate_metrics(
    real_images,                     # [N, C, H, W] uint8 [0, 255]
    generated_images,
    feature_fn: Callable,            # images -> [N, D]
    lpips_fn: Optional[Callable] = None,
    kid_subset_size: int = 100,
    lpips_pair_fn: Optional[Callable] = None,
) -> Tuple[float, float, float]:
    """(fid, kid, lpips) of two image batches (tensors on the towers'
    device).  FID from the biased covariances of the features, KID over 10
    subsets; LPIPS from ``lpips_pair_fn(a, b) -> [N]`` (exact pairwise, as
    ``make_alex_lpips``) or ``lpips_fn(images) -> [N, D]`` (an embedding
    whose squared L2 distance is LPIPS), on images mapped from uint8 to
    [-1, 1] for the pair fn; NaN without either."""
    real_f = _numpy(feature_fn(real_images))
    gen_f = _numpy(feature_fn(generated_images))

    mu_r, cov_r = real_f.mean(0), np.cov(real_f.T, bias=True)
    mu_g, cov_g = gen_f.mean(0), np.cov(gen_f.T, bias=True)
    fid = fid_lib.frechet_distance(mu_r, cov_r, mu_g, cov_g)

    kid = kid_lib.kid_from_features(
        real_f, gen_f, num_subsets=10,
        max_subset_size=min(kid_subset_size, real_f.shape[0]))

    lpips = float("nan")
    n = min(real_images.shape[0], generated_images.shape[0])
    if lpips_pair_fn is not None:
        a = torch.as_tensor(real_images[:n]).float() / 127.5 - 1.0
        b = torch.as_tensor(generated_images[:n]).float() / 127.5 - 1.0
        lpips = float(lpips_pair_fn(a, b).mean())
    elif lpips_fn is not None:
        a = lpips_fn(real_images[:n])
        b = lpips_fn(generated_images[:n])
        lpips = float((torch.as_tensor(a) - torch.as_tensor(b)).square()
                      .sum(dim=-1).mean())
    return fid, kid, lpips
