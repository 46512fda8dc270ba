"""Perceptual Path Length (port of gagan_tpu/metrics/ppl.py).

Each batch draws z0, z1, t and one noise key from the key tree of
``rng_seed`` (``MetricOptions.rng`` injects another), interpolates in w
(lerp) or z (slerp), renders both ends with ``force_fp32=True`` and random
noise from that one key (the fused level then runs its fp32 route),
crops (rows 3/8-7/8, columns 2/8-6/8), averages down to 256 by whole
factors and scores the pair with the LPIPS embedding (VGG16-LPIPS by
default), divided by epsilon^2.  The mean is taken between the 1st and
99th percentiles.
"""

from __future__ import annotations

import numpy as np
import torch

from . import feature_stats as fs


def slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation of the rows of ``a`` and ``b``."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    d = (a * b).sum(dim=-1, keepdim=True)
    p = t * torch.arccos(d)
    c = b - d * a
    c = c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    d = a * torch.cos(p) + c * torch.sin(p)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def compute_ppl(opts: fs.MetricOptions, num_samples: int,
                epsilon: float = 1e-4, space: str = "w",
                sampling: str = "end", crop: bool = True,
                detector_name: str = "vgg16_lpips") -> float:
    from ..models import stylegan2 as sg2

    g_cfg = opts.g_cfg
    params = opts.g_params
    lpips = fs.get_detector(opts, detector_name)
    batch = opts.batch_size
    dataset = opts.dataset
    has_labels = dataset is not None and dataset.label_dim > 0

    def sampler(z0, z1, c, t, key):
        mapping = lambda z: sg2.mapping_apply(g_cfg.mapping, params["mapping"],
                                              z, c)
        if space == "w":
            w0, w1 = mapping(z0), mapping(z1)
            tt = t[:, None, None]
            wt0 = w0 + (w1 - w0) * tt
            wt1 = w0 + (w1 - w0) * (tt + epsilon)
        else:
            wt0 = mapping(slerp(z0, z1, t[:, None]))
            wt1 = mapping(slerp(z0, z1, t[:, None] + epsilon))
        # One noise key for both ends, so the pair shares its noise.
        img = sg2.synthesis_apply(g_cfg.synthesis, params["synthesis"],
                                  torch.cat([wt0, wt1]), noise_mode="random",
                                  generator=key, force_fp32=True,
                                  hooks=opts.hooks)
        if crop:
            c8 = img.shape[2] // 8
            img = img[:, :, c8 * 3: c8 * 7, c8 * 2: c8 * 6]
        factor = img.shape[2] // 256 if img.shape[2] >= 256 else 1
        if factor > 1:
            n, ch, h, w = img.shape
            img = img.reshape(n, ch, h // factor, factor, w // factor,
                              factor).mean(dim=(3, 5))
        img = (img + 1) * (255 / 2)
        if g_cfg.img_channels == 1:
            img = img.repeat(1, 3, 1, 1)
        f0, f1 = lpips(img).chunk(2)
        return (f0 - f1).square().sum(dim=1) / epsilon ** 2

    key = opts.root_key()
    rnd = np.random.RandomState(opts.rng_seed)
    dist = []
    n_done = 0
    with torch.no_grad():
        while n_done < num_samples:
            key, k0, k1, kt, kn = key.split(5)
            z0 = k0.normal((batch, g_cfg.z_dim), device=opts.device)
            z1 = k1.normal((batch, g_cfg.z_dim), device=opts.device)
            t = kt.uniform((batch,), device=opts.device) * (
                1.0 if sampling == "full" else 0.0)
            c = None
            if has_labels:
                c = torch.from_numpy(np.stack([
                    dataset.get_label(rnd.randint(len(dataset)))
                    for _ in range(batch)])).to(opts.device)
            dist.append(sampler(z0, z1, c, t, kn).cpu().numpy())
            n_done += batch

    dist = np.concatenate(dist)[:num_samples]
    lo = np.percentile(dist, 1, method="lower")
    hi = np.percentile(dist, 99, method="higher")
    return float(np.extract((dist >= lo) & (dist <= hi), dist).mean())
