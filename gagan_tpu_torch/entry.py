"""Entry points of the port.

* :func:`entry`: the FFHQ-1024 StyleGAN2 generator forward, the counterpart
  of ``__graft_entry__.entry()`` of the JAX package, with the eligible
  synthesis levels routed through the fused modconv kernel
  (``pallas_level=True``).
* :func:`train_entry`: the adversarial train step at FFHQ-1024 on one card,
  the one-device counterpart of ``__graft_entry__.dryrun_multichip`` at
  full width, configured as the JAX package's training CLI configures a
  1024^2 run (``cli/train.py``, ``--cfg auto``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from . import resolve_device
from .models import stylegan2 as sg2
from .train import augment, gan_loss, train_step as ts
from .utils.rng import Rng


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


def _rounds_for(device_batch: int, cap: int) -> int:
    """The fewest rounds that divide the batch with at most ``cap`` live
    samples each (cli/train.py's auto plan)."""
    r = -(-device_batch // cap)
    while device_batch % r:
        r += 1
    return r


def train_configs(batch: int = 32, img_resolution: int = 1024,
                  channel_base: Optional[int] = None):
    """(g_cfg, d_cfg, train_cfg, augment_cfg) of a one-card ADA run, as the
    JAX training CLI builds them (``--cfg auto``, simultaneous phases,
    ``bgc`` augment): G is :func:`entry_config`; D is resnet with the packed
    first block, bf16 in its 4 highest resolutions and conv_clamp 256; at
    1024^2 and up the phases run in rounds of at most 8 live samples (Greg
    16).  ``channel_base`` overrides both networks' (for small CPU runs)."""
    res = img_resolution
    cb = channel_base or int((1 if res >= 512 else 0.5) * 32768)
    g_cfg = entry_config()
    g_cfg = dataclasses.replace(
        g_cfg, img_resolution=res, synthesis=dataclasses.replace(
            g_cfg.synthesis, channel_base=cb, packed_last_block=res >= 64))
    d_cfg = sg2.DiscriminatorConfig(
        img_resolution=res, channel_base=cb, channel_max=512, num_fp16_res=4,
        conv_clamp=256, mbstd_group_size=min(batch, 4),
        packed_first_block=res >= 64)
    rounds = (1, None, None)
    if res >= 1024:
        rounds = (_rounds_for(batch, 8), _rounds_for(batch, 16),
                  _rounds_for(batch, 8))
    train_cfg = ts.TrainConfig(
        g_lr=0.002 if res >= 1024 else 0.0025,
        d_lr=0.002 if res >= 1024 else 0.0025,
        ema_kimg=batch * 10 / 32, ema_rampup=0.05, ada_target=0.6,
        batch_size=batch, accum_rounds=rounds[0],
        g_reg_accum_rounds=rounds[1], d_reg_accum_rounds=rounds[2],
        loss=gan_loss.GANLossConfig(r1_gamma=0.0002 * res ** 2 / batch),
        simultaneous_main=True)
    augment_cfg = augment.make_config(
        "bgc", compute_dtype="bfloat16" if res >= 256 else None)
    return g_cfg, d_cfg, train_cfg, augment_cfg


def train_entry(device="cuda", batch: int = 32, img_resolution: int = 1024,
                channel_base: Optional[int] = None, ada_p: float = 0.0):
    """Returns ``steps, state, inputs``:

    * ``steps``: the three step variants a run schedules, {"none": Gmain +
      Dmain, "greg": + Greg, "both": + Greg + Dreg} (Greg every 4 batches,
      Dreg every 16), each ``step(state, real, real_c, z, gen_c, key) ->
      (state, metrics)``.  Greg runs with ``pallas_level=False``: the fused
      level is differentiable once and the path length needs twice.
    * ``state``: random weights (G from seed 0, D from seed 1), Adam state,
      ``ada_p`` as given.
    * ``inputs``: (real images in [-1, 1], None, z, None, key), from seeds
      2 and 3, on ``device``.

    Raises without CUDA unless ``device`` is 'cpu'."""
    device = resolve_device(device)
    g_cfg, d_cfg, cfg, aug_cfg = train_configs(batch, img_resolution,
                                               channel_base)
    g_params = sg2.init_generator(g_cfg, torch.Generator().manual_seed(0),
                                  device)
    d_params = sg2.init_discriminator(d_cfg, torch.Generator().manual_seed(1),
                                      device)
    g_tx, d_tx, _, _ = ts.build_optimizers(cfg, g_params, d_params)
    state = ts.init_train_state(cfg, g_params, d_params, g_tx, d_tx)
    state.ada_p = torch.tensor(float(ada_p), device=device)
    pl_g_cfg = dataclasses.replace(g_cfg, synthesis=dataclasses.replace(
        g_cfg.synthesis, pallas_level=False))
    augment_fn = augment.make_augment_fn(aug_cfg)
    steps: Dict[str, object] = {}
    for name, do_g, do_d in (("none", False, False), ("greg", True, False),
                             ("both", True, True)):
        steps[name] = ts.make_fused_step(
            cfg, g_cfg, d_cfg, g_tx, d_tx, augment_fn=augment_fn,
            do_g_reg=do_g, do_d_reg=do_d, reg_g_cfg=pl_g_cfg if do_g else None)
    gen = torch.Generator().manual_seed(2)
    res = g_cfg.img_resolution
    real = (torch.rand((batch, g_cfg.img_channels, res, res), generator=gen)
            * 2 - 1).to(device)
    z = torch.randn((batch, g_cfg.z_dim), generator=gen).to(device)
    return steps, state, (real, None, z, None, Rng(3))
