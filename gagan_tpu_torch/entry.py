"""Entry point of the port: the FFHQ-1024 StyleGAN2 generator forward, the
counterpart of ``__graft_entry__.entry()`` of the JAX package, with the
eligible synthesis levels routed through the fused modconv kernel
(``pallas_level=True``).
"""

from __future__ import annotations

import torch

from . import resolve_device
from .models import stylegan2 as sg2


def entry_config(pallas_level: bool = True) -> sg2.GeneratorConfig:
    """FFHQ-1024: bf16 from 128x128 up, conv_clamp 256, packed last block."""
    return sg2.GeneratorConfig(
        img_resolution=1024,
        synthesis=sg2.SynthesisConfig(num_fp16_res=4, conv_clamp=256,
                                      packed_last_block=True,
                                      pallas_level=pallas_level))


def entry(device="cuda", batch: int = 4):
    """Returns ``forward, (params, z)``: random FFHQ-1024 weights (seed 0)
    and a batch of latents (seed 1) on ``device``, and the const-noise
    generator forward over them.  Raises without CUDA unless ``device`` is
    'cpu'."""
    device = resolve_device(device)
    cfg = entry_config()
    params = sg2.init_generator(cfg, torch.Generator().manual_seed(0), device)
    z = torch.randn((batch, cfg.z_dim),
                    generator=torch.Generator().manual_seed(1)).to(device)

    def forward(params, z):
        with torch.no_grad():
            return sg2.generator_apply(cfg, params, z, noise_mode="const")

    return forward, (params, z)

