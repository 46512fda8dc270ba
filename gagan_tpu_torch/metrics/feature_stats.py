"""Feature statistics of a dataset and of a generator (port of
gagan_tpu/metrics/feature_stats.py).

``FeatureStats`` captures features whole and/or as a running mean and
covariance in float64; ``save`` pickles its ``__dict__`` with the JAX
class's keys, so a cache file written by either package loads in the other.
The dataset loop caches its statistics under the JAX module's file name
(the dataset's name, the detector's tag and the md5 of the same argument
dict).  The generator loop draws each batch's latents and noise key from
the key tree of ``rng_seed`` through the ``Rng`` interface
(``MetricOptions.rng`` injects another tree, e.g. JAX's), and labels from
``np.random.RandomState(rng_seed)``; images are clipped to uint8 before
the detector.  Detectors run under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..utils.rng import Rng


class FeatureStats:
    """Accumulate features: raw capture and/or running mean+cov."""

    def __init__(self, capture_all: bool = False,
                 capture_mean_cov: bool = False,
                 max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = []
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features: int):
        if self.num_features is not None:
            assert num_features == self.num_features
        else:
            self.num_features = num_features
            self.raw_mean = np.zeros([num_features], dtype=np.float64)
            self.raw_cov = np.zeros([num_features, num_features],
                                    dtype=np.float64)

    def is_full(self) -> bool:
        return (self.max_items is not None
                and self.num_items >= self.max_items)

    def append(self, x):
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        x = np.asarray(x, dtype=np.float32)
        assert x.ndim == 2
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            if self.num_items + x.shape[0] > self.max_items:
                x = x[: self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self) -> np.ndarray:
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items
        cov = cov - np.outer(mean, mean)
        return mean, cov

    def save(self, pkl_file: str):
        with open(pkl_file, "wb") as f:
            pickle.dump(self.__dict__, f)

    @staticmethod
    def load(pkl_file: str) -> "FeatureStats":
        """A cache file this program (or the JAX package) wrote: unpickling
        runs code, so never point it at a file of unknown origin."""
        with open(pkl_file, "rb") as f:
            s = pickle.load(f)
        obj = FeatureStats(capture_all=s["capture_all"],
                           capture_mean_cov=s["capture_mean_cov"],
                           max_items=s["max_items"])
        obj.__dict__.update(s)
        return obj


@dataclasses.dataclass
class MetricOptions:
    """Evaluation context: the JAX package's fields, plus ``device`` (where
    the generator and the detectors run) and ``rng`` (the root key of the
    generator loops' draws; None: ``Rng(rng_seed)``)."""

    g_params: Any = None                  # generator params tree (G_ema)
    g_cfg: Any = None                     # GeneratorConfig
    dataset: Any = None                   # ImageFolderDataset
    detectors: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hooks: Any = None                     # offsets hooks for adapted models
    cache_dir: Optional[str] = None
    batch_size: int = 16
    rng_seed: int = 0
    progress: Optional[Callable[[int, int], None]] = None
    verbose: bool = False
    device: Any = "cuda"
    rng: Any = None

    def root_key(self):
        return self.rng if self.rng is not None else Rng(self.rng_seed)


def get_detector(opts: MetricOptions, name: str):
    """The named feature detector ('inception', 'vgg16', ...): one
    registered on ``opts.detectors``, else detectors.make_default's on
    ``opts.device`` (then registered)."""
    if name in opts.detectors:
        return opts.detectors[name]
    from . import detectors

    det = detectors.make_default(name, opts.device)
    opts.detectors[name] = det
    return det


def compute_feature_stats_for_dataset(
    opts: MetricOptions,
    detector_name: str,
    capture_all: bool = False,
    capture_mean_cov: bool = False,
    max_items: Optional[int] = None,
    data_range: int = 255,
) -> FeatureStats:
    """Dataset features, cached on disk under ``opts.cache_dir``."""
    dataset = opts.dataset
    detector = get_detector(opts, detector_name)

    cache_file = None
    if opts.cache_dir is not None:
        args = dict(dataset=dataset.name, size=len(dataset),
                    detector=getattr(detector, "name", detector_name),
                    capture_all=capture_all,
                    capture_mean_cov=capture_mean_cov, max_items=max_items)
        md5 = hashlib.md5(repr(sorted(args.items())).encode()).hexdigest()
        tag = f"{dataset.name}-{getattr(detector, 'name', detector_name)}"
        cache_file = os.path.join(opts.cache_dir, f"{tag}-{md5}.pkl")
        if os.path.isfile(cache_file):
            return FeatureStats.load(cache_file)

    num_items = len(dataset)
    if max_items is not None:
        num_items = min(num_items, max_items)
    stats = FeatureStats(capture_all=capture_all,
                         capture_mean_cov=capture_mean_cov,
                         max_items=num_items)

    with torch.no_grad():
        for start in range(0, num_items, opts.batch_size):
            idxs = range(start, min(start + opts.batch_size, num_items))
            images = np.stack([dataset[i][0] for i in idxs])
            stats.append(detector(torch.from_numpy(images).to(opts.device)))
            if opts.progress:
                opts.progress(stats.num_items, num_items)
            if stats.is_full():
                break

    if cache_file is not None:
        os.makedirs(os.path.dirname(cache_file), exist_ok=True)
        stats.save(cache_file)
    return stats


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """Generator output in [-1, 1] -> uint8, clipped and truncated as the
    JAX loop casts it."""
    return torch.clamp(img * 127.5 + 128, 0, 255).to(torch.uint8)


def compute_feature_stats_for_generator(
    opts: MetricOptions,
    detector_name: str,
    capture_all: bool = False,
    capture_mean_cov: bool = False,
    max_items: Optional[int] = None,
    truncation_psi: float = 1.0,
) -> FeatureStats:
    """Generator features over batches of ``opts.batch_size`` samples with
    random noise, until ``max_items``."""
    from ..models import stylegan2 as sg2

    g_cfg = opts.g_cfg
    detector = get_detector(opts, detector_name)
    stats = FeatureStats(capture_all=capture_all,
                         capture_mean_cov=capture_mean_cov,
                         max_items=max_items)

    dataset = opts.dataset
    has_labels = dataset is not None and dataset.label_dim > 0

    key = opts.root_key()
    rnd = np.random.RandomState(opts.rng_seed)
    with torch.no_grad():
        while not stats.is_full():
            key, k_z, k_n = key.split(3)
            z = k_z.normal((opts.batch_size, g_cfg.z_dim), device=opts.device)
            c = None
            if has_labels:
                c = torch.from_numpy(np.stack([
                    dataset.get_label(rnd.randint(len(dataset)))
                    for _ in range(opts.batch_size)])).to(opts.device)
            img = sg2.generator_apply(g_cfg, opts.g_params, z, c=c,
                                      truncation_psi=truncation_psi,
                                      noise_mode="random", generator=k_n,
                                      hooks=opts.hooks)
            stats.append(detector(to_uint8(img)))
            if opts.progress:
                opts.progress(stats.num_items, max_items or 0)
    return stats
