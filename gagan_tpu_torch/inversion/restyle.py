"""ReStyle iterative encoders (port of gagan_tpu/inversion/restyle.py).

The six encoder types of ReStyle: single-map pSp / e4e encoders, whose
style heads all read the final 512x16x16 map, and the FPN (GradualStyle)
encoders, each over the IR-SE-50 or a ResNet34 backbone; and the iterative
inference protocol: a 6-channel input [image ; previous reconstruction],
residual latents accumulated over 5 iterations, the first conditioned on
the average image.  Parameter keys are the torch state-dict keys of the
reference encoders (``conv1.weight``, ``body.N.conv1``, ``styles.N.convs.0``,
``latlayer1``, ...), so converted checkpoints load as they are
(``cli/convert_weights.py restyle``).

Batch norm uses its running statistics.  Each iteration is one batched pass
of encoder and generator; the decode is float32 (the generator's output),
and the encoder's input is the float32 concatenation of the image and the
pooled decode.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..models import stylegan2 as sg2
from ..utils import checkpoint as ckpt_lib
from ..utils.observability import trace_scope
from . import encoders as enc

Params = Dict

ENCODER_TYPES = (
    "BackboneEncoder",                    # restyle pSp, IR-SE-50
    "ResNetBackboneEncoder",              # restyle pSp, ResNet34
    "ProgressiveBackboneEncoder",         # restyle e4e, IR-SE-50
    "ResNetProgressiveBackboneEncoder",   # restyle e4e, ResNet34
    "GradualStyleEncoder",                # pSp FPN, IR-SE-50
    "ResNetGradualStyleEncoder",          # pSp FPN, ResNet34
)


def resnet34_blocks() -> List[Tuple[int, int, int]]:
    """(in channels, depth, stride) of torchvision resnet34's 16
    BasicBlocks, flattened into one ``body`` (no maxpool before it)."""
    plan = []
    for in_c, depth, n_units in [(64, 64, 3), (64, 128, 4), (128, 256, 6),
                                 (256, 512, 3)]:
        stride = 1 if in_c == depth else 2
        plan.append((in_c, depth, stride))
        plan.extend((depth, depth, 1) for _ in range(n_units - 1))
    return plan


# The FPN taps of the ResNet34 body: after layer2 (128 channels), layer3
# (256) and layer4 (512).
RESNET_TAPS = {6: "c1", 12: "c2", 15: "c3"}


def _basic_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """conv3-bn-relu-conv3-bn plus the (downsampled) input."""
    y = F.relu(enc._bn(p["bn1"], enc._conv(x, p["conv1"]["weight"],
                                           stride=stride, padding=1)))
    y = enc._bn(p["bn2"], enc._conv(y, p["conv2"]["weight"], padding=1))
    if "downsample" in p:
        x = enc._bn(p["downsample"]["1"],
                    enc._conv(x, p["downsample"]["0"]["weight"],
                              stride=stride))
    return F.relu(y + x)


def resnet34_features(params: Params, x: torch.Tensor,
                      want_taps: bool = False) -> Dict[str, torch.Tensor]:
    """conv1 (7x7, stride 2), bn, the PReLU stored as ``relu``, then the 16
    blocks.  Returns {"final"} and, with ``want_taps``, {"c1", "c2",
    "c3"}."""
    with trace_scope("restyle_backbone"):
        x = enc._conv(x, params["conv1"]["weight"], stride=2, padding=3)
        x = F.prelu(enc._bn(params["bn1"], x), params["relu"]["weight"])
        feats = {}
        for i, (_, _, stride) in enumerate(resnet34_blocks()):
            x = _basic_block(params["body"][str(i)], x, stride)
            if want_taps and i in RESNET_TAPS:
                feats[RESNET_TAPS[i]] = x
    feats["final"] = x
    return feats


@dataclasses.dataclass(frozen=True)
class RestyleEncoderConfig:
    """Shapes of one ReStyle encoder; ``input_nc=6`` is the iterative
    protocol's input (image and previous reconstruction)."""
    encoder_type: str = "ProgressiveBackboneEncoder"
    stylegan_size: int = 1024
    input_nc: int = 6
    mode: str = "ir_se"       # IR backbones: 'ir' or 'ir_se'
    coarse_ind: int = 3       # FPN variants only
    middle_ind: int = 7

    def __post_init__(self):
        assert self.encoder_type in ENCODER_TYPES, self.encoder_type

    @property
    def style_count(self) -> int:
        return 2 * int(np.log2(self.stylegan_size)) - 2

    @property
    def is_resnet(self) -> bool:
        return self.encoder_type.startswith("ResNet")

    @property
    def is_progressive(self) -> bool:
        return "Progressive" in self.encoder_type

    @property
    def is_fpn(self) -> bool:
        return "GradualStyle" in self.encoder_type


def _styles_from_final(cfg: RestyleEncoderConfig, params: Params,
                       x: torch.Tensor, stage: Optional[int] = None
                       ) -> torch.Tensor:
    """Single-map heads: every head reads the final 16x16 map.  The
    progressive variants emit w0 plus per-layer deltas; with ``stage``,
    the layers past it repeat w0 (None: all layers)."""
    styles = params["styles"]
    if not cfg.is_progressive:
        return torch.stack([enc._gradual_style_block(styles[str(j)], x, 16)
                            for j in range(cfg.style_count)], dim=1)
    stage = cfg.style_count if stage is None else stage
    w0 = enc._gradual_style_block(styles["0"], x, 16)
    ws = [w0]
    for i in range(1, cfg.style_count):
        if i < min(stage + 1, cfg.style_count):
            ws.append(w0 + enc._gradual_style_block(styles[str(i)], x, 16))
        else:
            ws.append(w0)
    return torch.stack(ws, dim=1)


def _fpn_styles(cfg: RestyleEncoderConfig, params: Params,
                feats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """GradualStyle heads over the three taps."""
    c1, c2, c3 = feats["c1"], feats["c2"], feats["c3"]
    styles = params["styles"]
    latents = [enc._gradual_style_block(styles[str(j)], c3, 16)
               for j in range(cfg.coarse_ind)]
    p2 = enc._upsample_add(c3, enc._lateral(params, "latlayer1", c2))
    latents += [enc._gradual_style_block(styles[str(j)], p2, 32)
                for j in range(cfg.coarse_ind, cfg.middle_ind)]
    p1 = enc._upsample_add(p2, enc._lateral(params, "latlayer2", c1))
    latents += [enc._gradual_style_block(styles[str(j)], p1, 64)
                for j in range(cfg.middle_ind, cfg.style_count)]
    return torch.stack(latents, dim=1)


def restyle_encode(cfg: RestyleEncoderConfig, params: Params,
                   x: torch.Tensor, stage: Optional[int] = None
                   ) -> torch.Tensor:
    """[N, input_nc, 256, 256] -> [N, style_count, 512]; ``stage`` limits
    the progressive variants' deltas (None: inference, all layers)."""
    if cfg.is_resnet:
        feats = resnet34_features(params, x, want_taps=cfg.is_fpn)
    else:
        feats = enc.backbone_features(params, x, want_final=True)
    if cfg.is_fpn:
        return _fpn_styles(cfg, params, feats)
    return _styles_from_final(cfg, params, feats["final"], stage=stage)


# ----------------------------------------------------------------------------
# The iterative protocol


def adaptive_avg_pool(img: torch.Tensor, size: int = 256) -> torch.Tensor:
    """AdaptiveAvgPool2d((size, size)) for sizes that divide the input: the
    psp / e4e face pool, a mean over each block."""
    n, c, h, w = img.shape
    if h == size and w == size:
        return img
    assert h % size == 0 and w % size == 0, (h, w, size)
    return img.reshape(n, c, size, h // size, size, w // size).mean(dim=(3, 5))


@dataclasses.dataclass(frozen=True)
class RestyleNet:
    """Encoder, frozen generator and ``latent_avg`` [style_count, 512]: the
    psp / e4e wrapper as data."""
    enc_cfg: RestyleEncoderConfig
    enc_params: Params
    g_cfg: sg2.GeneratorConfig
    g_params: Params
    latent_avg: torch.Tensor

    def decode(self, codes: torch.Tensor, resize: bool = True) -> torch.Tensor:
        img = sg2.synthesis_apply(self.g_cfg.synthesis,
                                  self.g_params["synthesis"], codes,
                                  noise_mode="const")
        return adaptive_avg_pool(img) if resize else img

    def forward(self, x: torch.Tensor, latent: Optional[torch.Tensor] = None,
                resize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """One iteration: codes = encoder(x) + (``latent`` or latent_avg),
        decoded.  Returns (images, codes)."""
        codes = restyle_encode(self.enc_cfg, self.enc_params, x)
        codes = codes + (self.latent_avg[None] if latent is None else latent)
        return self.decode(codes, resize=resize), codes


def get_avg_image(net: RestyleNet) -> torch.Tensor:
    """latent_avg decoded and pooled to 256^2: [3, 256, 256]."""
    return net.decode(net.latent_avg[None])[0]


@torch.no_grad()
def run_on_batch(net: RestyleNet, inputs: torch.Tensor, n_iters: int = 5,
                 resize_outputs: bool = False
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The iterative protocol: iteration 0 conditions on [inputs ; average
    image] and latent_avg, each later one on the pooled previous decode and
    the accumulated codes.  ``inputs`` [N, 3, 256, 256]; returns the
    per-iteration images [N, 3, H, W] (pooled to 256^2 with
    ``resize_outputs``) and latents [N, style_count, 512]; [-1] is the
    result."""
    assert inputs.shape[1] == 3 and tuple(inputs.shape[2:]) == (256, 256), \
        inputs.shape
    inputs = inputs.float()
    y_hat = get_avg_image(net)[None].expand_as(inputs)
    latent = net.latent_avg[None].expand(
        (inputs.shape[0],) + tuple(net.latent_avg.shape))
    images, latents = [], []
    for _ in range(n_iters):
        x = torch.cat([inputs, y_hat.float()], dim=1)
        latent = restyle_encode(net.enc_cfg, net.enc_params, x) + latent
        img = net.decode(latent, resize=False)
        y_hat = adaptive_avg_pool(img)
        images.append(y_hat if resize_outputs else img)
        latents.append(latent)
    return images, latents


# ----------------------------------------------------------------------------
# Initialisation (random; pretrained checkpoints convert to the same keys)


def _init_resnet34(gen, input_nc: int, device) -> Params:
    p: Params = {"conv1": enc._init_conv(gen, 64, input_nc, 7, device=device),
                 "bn1": enc._init_bn(64, device),
                 "relu": enc._init_prelu(64, device), "body": {}}
    for i, (in_c, depth, stride) in enumerate(resnet34_blocks()):
        blk: Params = {
            "conv1": enc._init_conv(gen, depth, in_c, 3, device=device),
            "bn1": enc._init_bn(depth, device),
            "conv2": enc._init_conv(gen, depth, depth, 3, device=device),
            "bn2": enc._init_bn(depth, device)}
        if stride != 1 or in_c != depth:
            blk["downsample"] = {
                "0": enc._init_conv(gen, depth, in_c, 1, device=device),
                "1": enc._init_bn(depth, device)}
        p["body"][str(i)] = blk
    return p


def init_restyle_encoder(gen: torch.Generator, cfg: RestyleEncoderConfig,
                         device="cpu") -> Params:
    """Random parameters of the JAX init's tree, shapes and scales, drawn on
    the CPU from ``gen`` and moved to ``device`` as they are drawn."""
    if cfg.is_resnet:
        p = _init_resnet34(gen, cfg.input_nc, device)
    else:
        p = {"input_layer": {
                "0": enc._init_conv(gen, 64, cfg.input_nc, 3, device=device),
                "1": enc._init_bn(64, device), "2": enc._init_prelu(64, device)},
             "body": enc._init_ir_body(gen, cfg.mode, device)}
    p["styles"] = {
        str(j): enc._init_style_block(gen, 16 if not cfg.is_fpn or
                                      j < cfg.coarse_ind else
                                      32 if j < cfg.middle_ind else 64, device)
        for j in range(cfg.style_count)}
    if cfg.is_fpn:
        p["latlayer1"] = enc._init_conv(gen, 512, 256, 1, True, device)
        p["latlayer2"] = enc._init_conv(gen, 512, 128, 1, True, device)
    return p


def load_net(path: str, device="cuda") -> RestyleNet:
    """A converted ReStyle npz ({enc/<key>, dec/<key>, latent_avg,
    __config__}, ``cli/convert_weights.py restyle``) as a RestyleNet on
    ``device``.  The decoder is a rosinality config-f generator: channel
    base 32768, an 8-layer mapping at lr multiplier 0.01, fp32 throughout
    and the fused level off, as the JAX package builds it.  Raises without
    CUDA unless ``device`` is 'cpu'."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__config__"]).decode())
        enc_flat = {k[len("enc/"):]: z[k] for k in z.files
                    if k.startswith("enc/")}
        dec_flat = {k[len("dec/"):]: z[k] for k in z.files
                    if k.startswith("dec/")}
        latent_avg = z["latent_avg"] if "latent_avg" in z.files else None
    size = int(meta["output_size"])
    enc_cfg = RestyleEncoderConfig(encoder_type=meta["encoder_type"],
                                   stylegan_size=size,
                                   input_nc=int(meta.get("input_nc", 6)))
    g_cfg = sg2.GeneratorConfig(
        img_resolution=size,
        mapping=sg2.MappingConfig(num_layers=8, lr_multiplier=0.01),
        synthesis=sg2.SynthesisConfig(channel_base=32768, channel_max=512))
    if latent_avg is None:
        latent_avg = np.zeros((enc_cfg.style_count, 512), np.float32)
    return RestyleNet(
        enc_cfg=enc_cfg,
        enc_params=ckpt_lib.flat_to_tree(enc_flat, device),
        g_cfg=g_cfg,
        g_params=ckpt_lib.flat_to_tree(dec_flat, device),
        latent_avg=torch.as_tensor(latent_avg, device=device))
