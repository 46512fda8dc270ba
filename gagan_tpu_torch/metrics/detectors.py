"""Named feature detectors (port of gagan_tpu/metrics/detectors.py).

Weights load from the npz files that ``cli/convert_weights.py`` writes
(the JAX package's flat keys: ``inception_v3.npz``, ``vgg16.npz``), found
in the directory ``GAGAN_DETECTOR_DIR`` names.  Without that variable a
detector has random weights of the real shape (the port's own draws, seed
0), tagged ``-random``: the machinery runs, the values need the real
weights.  A directory that is set but lacks the file raises (the JAX
module falls back to random weights there).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..utils import checkpoint as ckpt
from . import inception, vgg16


class Detector:
    def __init__(self, name: str, fn: Callable, num_features: int):
        self.name = name
        self._fn = fn
        self.num_features = num_features

    def __call__(self, images):
        return self._fn(images)


def _load_or_init(filename: str, init_fn, device):
    """(parameters on ``device``, whether they were loaded)."""
    det_dir = os.environ.get("GAGAN_DETECTOR_DIR", "")
    if not det_dir:
        return init_fn(torch.Generator().manual_seed(0), device), False
    path = os.path.join(det_dir, filename)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"GAGAN_DETECTOR_DIR={det_dir!r} holds no {filename} (convert it "
            f"with cli/convert_weights.py, or unset the variable to run with "
            f"random weights)")
    with np.load(path, allow_pickle=False) as data:
        return ckpt.flat_to_tree({k: data[k] for k in data.files}, device), True


def make_default(name: str, device="cuda") -> Detector:
    """The detector ``name`` on ``device``: "inception" (2048-d pool
    features), "inception_softmax" (the 1008 class probabilities of the
    logits without the bias), "vgg16" (4096-d features) or "vgg16_lpips"
    (the LPIPS embedding)."""
    device = resolve_device(device)
    if name in ("inception", "inception_softmax"):
        params, pretrained = _load_or_init(
            "inception_v3.npz",
            lambda g, d: inception.init_inception_v3(g, device=d), device)
        tag = "inception-2015-12-05" if pretrained else "inception-random"
        if name == "inception":
            return Detector(tag, lambda img: inception.inception_v3_features(
                params, img), 2048)

        def softmax_no_bias(img):
            _, logits, _ = inception.inception_v3_features(
                params, img, return_logits=True)
            return torch.softmax(logits, dim=1)

        return Detector(tag + "-softmax", softmax_no_bias, 1008)
    if name == "vgg16":
        params, pretrained = _load_or_init(
            "vgg16.npz", lambda g, d: vgg16.init_vgg16(g, device=d), device)
        return Detector("vgg16" if pretrained else "vgg16-random",
                        lambda img: vgg16.vgg16_features(params, img), 4096)
    if name == "vgg16_lpips":
        params, pretrained = _load_or_init(
            "vgg16.npz", lambda g, d: vgg16.init_vgg16(
                g, with_classifier=False, device=d), device)
        return Detector("vgg16-lpips" if pretrained else "vgg16-lpips-random",
                        lambda img: vgg16.vgg16_lpips(params, img), -1)
    raise ValueError(f"Unknown detector: {name}")
