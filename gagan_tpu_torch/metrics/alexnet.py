"""AlexNet taps and LPIPS(net='alex') (port of gagan_tpu/metrics/alexnet.py).

The GA's fitness metric is the ``lpips`` package's alex variant: the
scaling layer (x - shift) / scale on [-1, 1] inputs; torchvision AlexNet
``.features`` with a tap after the ReLU of each of its 5 convolutions
(MaxPool 3/2 without padding after the first two); per tap the channels
unit-normalised (eps 1e-10 added to the norm, outside the square root),
the squared difference weighted by the ``lin`` head and averaged over
space; the taps summed.  Parameter names are torchvision's
(``features.N.weight``) plus ``lin.N.weight`` and ``scaling.shift/scale``,
as the JAX module names them; ``cli/convert_weights.py lpips-alex`` writes
them.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import checkpoint as ckpt

Params = Dict[str, Any]

# torchvision AlexNet features: index -> (in, out, kernel, stride, pad).
ALEX_CONVS = {
    0: (3, 64, 11, 4, 2),
    3: (64, 192, 5, 1, 2),
    6: (192, 384, 3, 1, 1),
    8: (384, 256, 3, 1, 1),
    10: (256, 256, 3, 1, 1),
}
ALEX_POOLS = (2, 5)              # MaxPool2d(3, 2) positions
ALEX_TAPS = (1, 4, 7, 9, 11)     # ReLU outputs feeding the lin heads
LPIPS_CHANNELS = (64, 192, 384, 256, 256)

# lpips ScalingLayer constants.
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def alexnet_taps(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """Scaled input -> the 5 ReLU tap activations."""
    taps = []
    idx = 0
    while idx <= max(ALEX_TAPS):
        if idx in ALEX_CONVS:
            _, _, _, stride, pad = ALEX_CONVS[idx]
            p = params["features"][str(idx)]
            x = F.relu(F.conv2d(x, p["weight"].to(x.dtype), stride=stride,
                                padding=pad) + p["bias"][None, :, None, None])
            taps.append(x)
            idx += 2          # conv + relu
        elif idx in ALEX_POOLS:
            x = F.max_pool2d(x, 3, 2)
            idx += 1
        else:
            idx += 1
    return taps


def _scale_input(params: Params, images: torch.Tensor) -> torch.Tensor:
    scaling = params.get("scaling", {})
    shift = torch.as_tensor(scaling.get("shift", _SHIFT), device=images.device)
    scale = torch.as_tensor(scaling.get("scale", _SCALE), device=images.device)
    return (images - shift.reshape(1, 3, 1, 1)) / scale.reshape(1, 3, 1, 1)


def _unit_normalize(t: torch.Tensor) -> torch.Tensor:
    # lpips.normalize_tensor: x / (||x||_c + 1e-10)  (eps OUTSIDE the sqrt).
    norm = torch.sqrt(t.square().sum(dim=1, keepdim=True))
    return t / (norm + 1e-10)


def lpips_distance(params: Params, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """LPIPS(net='alex') per-pair distances [N] of [N, 3, H, W] images in
    [-1, 1] (lpips.LPIPS.forward with spatial=False)."""
    taps_a = alexnet_taps(params, _scale_input(params, a))
    taps_b = alexnet_taps(params, _scale_input(params, b))
    total = 0.0
    for i, (ta, tb) in enumerate(zip(taps_a, taps_b)):
        diff = (_unit_normalize(ta) - _unit_normalize(tb)).square()
        lin = params["lin"][str(i)]["weight"]          # [C]
        val = torch.einsum("nchw,c->n", diff, lin) / (
            diff.shape[2] * diff.shape[3])
        total = total + val
    return total


def lpips_embedding(params: Params, images: torch.Tensor) -> torch.Tensor:
    """Embedding whose squared L2 distance equals LPIPS (the ``lpips_fn``
    of ``ga.evaluation.calculate_metrics``).  Needs non-negative lin
    weights (the published ones are); negatives are clamped to 0."""
    taps = alexnet_taps(params, _scale_input(params, images))
    outs = []
    for i, t in enumerate(taps):
        lin = params["lin"][str(i)]["weight"]
        weighted = _unit_normalize(t) * torch.sqrt(
            torch.clamp_min(lin, 0.0))[None, :, None, None]
        h, w = weighted.shape[2:]
        outs.append((weighted / np.sqrt(h * w)).flatten(1))
    return torch.cat(outs, dim=1)


def init_alexnet_lpips(gen: torch.Generator, device="cpu") -> Params:
    """Random parameters drawn on the CPU from ``gen`` (the JAX module's
    scales: convs 0.05 N(0, 1), zero biases, lin |0.1 N(0, 1)|), then moved
    to ``device``."""
    features: Params = {}
    for idx, (in_c, out_c, k, _, _) in ALEX_CONVS.items():
        features[str(idx)] = {
            "weight": torch.randn((out_c, in_c, k, k), generator=gen) * 0.05,
            "bias": torch.zeros((out_c,))}
    lin = {str(i): {"weight": (torch.randn((c,), generator=gen) * 0.1).abs()}
           for i, c in enumerate(LPIPS_CHANNELS)}
    params = {"features": features, "lin": lin,
              "scaling": {"shift": torch.from_numpy(_SHIFT.copy()),
                          "scale": torch.from_numpy(_SCALE.copy())}}
    return ckpt.tree_to_device(params, device)


def load_params(path: str, device="cpu") -> Params:
    """The npz that ``cli/convert_weights.py lpips-alex`` writes."""
    with np.load(path, allow_pickle=False) as z:
        return ckpt.flat_to_tree({k: z[k] for k in z.files}, device)
