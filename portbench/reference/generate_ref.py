"""The plain reference of the generation cells: the generator forward in
float32 with TF32 off (composed levels, no packed block), and the weights
and latents that the benchmark hands to both sides."""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from . import train_ref
from .frozen.models import stylegan2 as sg2
from .frozen.ops import conv2d_gradfix
from .frozen.utils.checkpoint import tree_to_flat_tensors
from .frozen.utils.rng import Rng


def g_config(c: Dict[str, Any], precision: str = "float32"
             ) -> sg2.GeneratorConfig:
    """G of the configuration file, as the reference runs it ("float32"),
    or as the control ("control": every block in bf16, the configuration's
    bf16 blocks on fp8 operands; see ``train_ref.PRECISIONS``)."""
    return sg2.GeneratorConfig(
        z_dim=c["z_dim"], w_dim=c["w_dim"],
        img_resolution=c["img_resolution"], img_channels=c["img_channels"],
        mapping=sg2.MappingConfig(num_layers=c["mapping_layers"]),
        synthesis=sg2.SynthesisConfig(
            channel_base=c["channel_base"], channel_max=c["channel_max"],
            num_fp16_res=0 if precision == "float32" else 99,
            conv_clamp=c["conv_clamp"],
            fp8_resolution=(None if precision == "float32"
                            else train_ref.fp8_resolution(c))))


def make_weights(c: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """G's weights drawn on ``device`` from ``seed``, by the init's rules,
    then with every noise strength in [0.05, 0.3) and every synthesis bias
    N(0, 0.1^2) so that the noise and bias paths do work, and ``w_avg``
    the mean w of 1024 latents."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = g_config(c)
    params = sg2.init_generator(cfg, gen, device)
    with torch.no_grad():
        for name, leaf in tree_to_flat_tensors(params["synthesis"]).items():
            if name.endswith("noise_strength"):
                leaf.copy_(torch.rand((), generator=gen, device=device)
                           * 0.25 + 0.05)
            elif name.endswith(".bias") and ".affine." not in name:
                leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                       device=device) * 0.1)
        z = torch.randn((1024, cfg.z_dim), generator=gen, device=device)
        if "w_avg" in params["mapping"]:
            params["mapping"]["w_avg"].copy_(sg2.mapping_apply(
                cfg.mapping, params["mapping"], z, broadcast=False).mean(0))
    return params


def latents(seed: int, batch_index: int, batch: int, z_dim: int, device):
    """Batch ``batch_index``'s latents, from the seed."""
    return Rng(seed).fold_in(batch_index).normal((batch, z_dim),
                                                 device=device)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """cli/generate.py's conversion ([-1, 1] -> uint8, NCHW -> NHWC), on
    the device."""
    return (img.permute(0, 2, 3, 1).float() * 127.5 + 128).clamp(
        0, 255).to(torch.uint8)


def generate(c: Dict[str, Any], params, z: torch.Tensor,
             precision: str = "float32") -> torch.Tensor:
    """uint8 images of ``z``, as the reference computes them."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rounding = (conv2d_gradfix.control_rounding() if precision == "control"
                else contextlib.nullcontext())
    try:
        with torch.no_grad(), rounding:
            img = sg2.generator_apply(g_config(c, precision), params, z,
                                      noise_mode="const")
            return to_uint8(img)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
