"""pSp / e4e image -> W+ encoders (port of gagan_tpu/inversion/encoders.py).

The IR-SE-50 backbone (ArcFace's improved residual units with
squeeze-excitation) with FPN-style GradualStyle heads, as functions over a
parameter tree whose keys are the torch state-dict keys of the reference
encoders (``input_layer.0.weight``, ``body.N.res_layer.3.weight``,
``styles.N.convs.0.weight``, ``latlayer1.weight``, ...).  Batch norm always
uses its running statistics: no train mode exists here.  The encoders'
weights are constants of the functions, so a backward through them computes
the input's gradient only, unless the caller asks for weight gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize2d

Params = Dict[str, Any]


def ir50_blocks() -> List[Tuple[int, int, int]]:
    """(in channels, depth, stride) of each of the 24 IR-50 units."""
    plan = []
    for in_c, depth, n_units in [(64, 64, 3), (64, 128, 4), (128, 256, 14),
                                 (256, 512, 3)]:
        plan.append((in_c, depth, 2))
        plan.extend((depth, depth, 1) for _ in range(n_units - 1))
    return plan


# The units whose outputs feed the style heads.
TAPS = {6: "c1", 20: "c2", 23: "c3"}


def _conv(x, w, stride=1, padding=0, bias=None):
    return F.conv2d(x, w.to(x.dtype), None if bias is None else
                    bias.to(x.dtype), stride=stride, padding=padding)


def _bn(p, x, eps=1e-5):
    """Batch norm on the running statistics."""
    return F.batch_norm(x, p["running_mean"], p["running_var"], p["weight"],
                        p["bias"], training=False, eps=eps)


def _se_module(p, x):
    s = x.mean(dim=(2, 3), keepdim=True)
    s = F.relu(_conv(s, p["fc1"]["weight"]))
    return x * torch.sigmoid(_conv(s, p["fc2"]["weight"]))


def _bottleneck_ir_se(p, x, in_c, depth, stride):
    if in_c == depth:
        shortcut = x[:, :, ::stride, ::stride]       # MaxPool2d(1, stride)
    else:
        shortcut = _bn(p["shortcut_layer"]["1"],
                       _conv(x, p["shortcut_layer"]["0"]["weight"],
                             stride=stride))
    r = p["res_layer"]
    y = _bn(r["0"], x)
    y = _conv(y, r["1"]["weight"], padding=1)
    y = F.prelu(y, r["2"]["weight"])
    y = _conv(y, r["3"]["weight"], stride=stride, padding=1)
    y = _bn(r["4"], y)
    if "5" in r:                      # ir_se mode
        y = _se_module(r["5"], y)
    return y + shortcut


def backbone_features(params: Params, x: torch.Tensor,
                      want_final: bool = False) -> Dict[str, torch.Tensor]:
    """[N, 3, H, W] in [-1, 1] -> {"c1", "c2", "c3"} feature maps (and
    "final", the last unit's output, with ``want_final``)."""
    # Named for profiler traces.
    with torch.profiler.record_function("e4e_backbone"):
        il = params["input_layer"]
        x = _conv(x, il["0"]["weight"], padding=1)
        x = F.prelu(_bn(il["1"], x), il["2"]["weight"])
        feats = {}
        for i, (in_c, depth, stride) in enumerate(ir50_blocks()):
            x = _bottleneck_ir_se(params["body"][str(i)], x, in_c, depth,
                                  stride)
            if i in TAPS:
                feats[TAPS[i]] = x
    if want_final:
        feats["final"] = x
    return feats


def _gradual_style_block(p, x, spatial: int):
    """log2(spatial) stride-2 convs with LeakyReLU(0.01), then an
    EqualLinear (scale 1/sqrt(in))."""
    for i in range(int(np.log2(spatial))):
        c = p["convs"][str(2 * i)]
        x = F.leaky_relu(_conv(x, c["weight"], stride=2, padding=1,
                               bias=c["bias"]), 0.01)
    x = x.reshape(x.shape[0], -1)
    lin = p["linear"]
    return x @ (lin["weight"].t() * (1.0 / np.sqrt(x.shape[1]))) + lin["bias"]


def _upsample_add(x, y):
    """x resized (bilinear, as jax.image.resize) to y's size, plus y."""
    return resize2d(x, tuple(y.shape[2:]), "bilinear") + y


def _lateral(params, name, c):
    return _conv(c, params[name]["weight"], bias=params[name]["bias"])


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    stylegan_size: int = 1024
    mode: str = "ir_se"
    coarse_ind: int = 3
    middle_ind: int = 7

    @property
    def style_count(self) -> int:
        return 2 * int(np.log2(self.stylegan_size)) - 2


def psp_encode(cfg: EncoderConfig, params: Params,
               x: torch.Tensor) -> torch.Tensor:
    """GradualStyleEncoder forward -> [N, style_count, 512]."""
    f = backbone_features(params, x)
    c1, c2, c3 = f["c1"], f["c2"], f["c3"]
    styles = params["styles"]
    latents = [_gradual_style_block(styles[str(j)], c3, 16)
               for j in range(cfg.coarse_ind)]
    p2 = _upsample_add(c3, _lateral(params, "latlayer1", c2))
    latents += [_gradual_style_block(styles[str(j)], p2, 32)
                for j in range(cfg.coarse_ind, cfg.middle_ind)]
    p1 = _upsample_add(p2, _lateral(params, "latlayer2", c1))
    latents += [_gradual_style_block(styles[str(j)], p1, 64)
                for j in range(cfg.middle_ind, cfg.style_count)]
    return torch.stack(latents, dim=1)


def e4e_encode(cfg: EncoderConfig, params: Params, x: torch.Tensor,
               stage: int = None) -> torch.Tensor:
    """Encoder4Editing forward: w0 broadcast plus the progressive deltas of
    heads 1..stage -> [N, style_count, 512]."""
    stage = cfg.style_count if stage is None else stage
    f = backbone_features(params, x)
    c1, c2, c3 = f["c1"], f["c2"], f["c3"]
    w0 = _gradual_style_block(params["styles"]["0"], c3, 16)
    ws = [w0]
    features, spatial = c3, 16
    p2 = None
    for i in range(1, min(stage + 1, cfg.style_count)):
        if i == cfg.coarse_ind:
            p2 = _upsample_add(c3, _lateral(params, "latlayer1", c2))
            features, spatial = p2, 32
        elif i == cfg.middle_ind:
            features = _upsample_add(p2, _lateral(params, "latlayer2", c1))
            spatial = 64
        ws.append(w0 + _gradual_style_block(params["styles"][str(i)],
                                            features, spatial))
    ws += [w0] * (cfg.style_count - len(ws))
    return torch.stack(ws, dim=1)


def encode_image_to_wplus(cfg: EncoderConfig, params: Params,
                          images: torch.Tensor, latent_avg=None,
                          kind: str = "e4e") -> torch.Tensor:
    """The psp / e4e wrapper: resize to 256^2 (bilinear, antialiased),
    encode, add ``latent_avg`` when given."""
    x = images.float()
    if tuple(x.shape[2:]) != (256, 256):
        x = resize2d(x, (256, 256), "bilinear")
    ws = psp_encode(cfg, params, x) if kind == "psp" else \
        e4e_encode(cfg, params, x)
    if latent_avg is not None:
        ws = ws + latent_avg[None]
    return ws


# ----------------------------------------------------------------------------
# Random initialisation (pretrained weights convert to the same keys).


def init_encoder(gen: torch.Generator, cfg: EncoderConfig,
                 device="cpu") -> Params:
    """Random encoder parameters (the JAX module's shapes and scales) drawn
    on the CPU from ``gen``, each moved to ``device`` as it is drawn."""
    def conv(o, i, k, bias=False):
        p = {"weight": (torch.randn((o, i, k, k), generator=gen)
                        * 0.05).to(device)}
        if bias:
            p["bias"] = torch.zeros((o,), device=device)
        return p

    def bn(n):
        return {"weight": torch.ones((n,), device=device),
                "bias": torch.zeros((n,), device=device),
                "running_mean": torch.zeros((n,), device=device),
                "running_var": torch.ones((n,), device=device)}

    def prelu(n):
        return {"weight": torch.full((n,), 0.25, device=device)}

    p: Params = {"input_layer": {"0": conv(64, 3, 3), "1": bn(64),
                                 "2": prelu(64)},
                 "body": {}, "styles": {},
                 "latlayer1": conv(512, 256, 1, bias=True),
                 "latlayer2": conv(512, 128, 1, bias=True)}
    for i, (in_c, depth, _) in enumerate(ir50_blocks()):
        res = {"0": bn(in_c), "1": conv(depth, in_c, 3), "2": prelu(depth),
               "3": conv(depth, depth, 3), "4": bn(depth)}
        if cfg.mode == "ir_se":
            res["5"] = {"fc1": conv(depth // 16, depth, 1),
                        "fc2": conv(depth, depth // 16, 1)}
        blk: Params = {"res_layer": res}
        if in_c != depth:
            blk["shortcut_layer"] = {"0": conv(depth, in_c, 1), "1": bn(depth)}
        p["body"][str(i)] = blk
    for j in range(cfg.style_count):
        spatial = 16 if j < cfg.coarse_ind else (
            32 if j < cfg.middle_ind else 64)
        p["styles"][str(j)] = {
            "convs": {str(2 * i): conv(512, 512, 3, bias=True)
                      for i in range(int(np.log2(spatial)))},
            "linear": {"weight": torch.randn((512, 512),
                                             generator=gen).to(device),
                       "bias": torch.zeros((512,), device=device)}}
    return p
