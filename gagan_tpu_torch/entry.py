"""Entry points of the port.

* :func:`entry`: the FFHQ-1024 StyleGAN2 generator forward, the counterpart
  of ``__graft_entry__.entry()`` of the JAX package, with the eligible
  synthesis levels routed through the fused modconv kernel
  (``pallas_level=True``).
* :func:`train_entry`: the adversarial train step at FFHQ-1024 on one card,
  the one-device counterpart of ``__graft_entry__.dryrun_multichip`` at
  full width, configured by the port's training CLI's plan for a 1024^2 run
  (``cli/train.py::build_run``, ``--cfg auto``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from . import resolve_device
from .models import stylegan2 as sg2
from .cli import train as train_cli
from .train import augment, train_step as ts
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


def train_run(batch: int = 32, img_resolution: int = 1024,
              channel_base: Optional[int] = None):
    """The training CLI's run (``cli/train.py::build_run``, ``--cfg auto``,
    the defaults) for ``batch`` RGB images at ``img_resolution``^2 on one
    card; ``channel_base`` overrides both networks' (for small CPU runs)."""
    run = train_cli.build_run(img_resolution, 3, 0, batch=batch)
    if channel_base:
        run = dataclasses.replace(
            run, g_cfg=dataclasses.replace(
                run.g_cfg, synthesis=dataclasses.replace(
                    run.g_cfg.synthesis, channel_base=channel_base)),
            d_cfg=dataclasses.replace(run.d_cfg, channel_base=channel_base))
    return run


def train_configs(batch: int = 32, img_resolution: int = 1024,
                  channel_base: Optional[int] = None):
    """(g_cfg, d_cfg, train_cfg, augment_cfg) of :func:`train_run`: at
    FFHQ-1024 and batch 32, G is :func:`entry_config` with the CLI's 2
    mapping layers; D is resnet with the packed first block, bf16 in its 4
    highest resolutions and conv_clamp 256; the phases run in rounds of at
    most 8 live samples (Greg 16); the ADA pipe is ``bgc`` in bf16."""
    run = train_run(batch, img_resolution, channel_base)
    return run.g_cfg, run.d_cfg, run.train_cfg, run.augment_cfg


def train_entry(device="cuda", batch: int = 32, img_resolution: int = 1024,
                channel_base: Optional[int] = None, ada_p: float = 0.0):
    """Returns ``steps, state, inputs``:

    * ``steps``: the three step variants a run schedules, {"none": Gmain +
      Dmain, "greg": + Greg, "both": + Greg + Dreg} (Greg every 4 batches,
      Dreg every 16), each ``step(state, real, real_c, z, gen_c, key) ->
      (state, metrics)``, as the training loop builds them.  Greg runs with
      ``pallas_level=False``: the fused level is differentiable once and
      the path length needs twice.  At 1024^2 the R1 phase runs a remat'd
      D (the CLI's ``reg_remat``).
    * ``state``: random weights (G from seed 0, D from seed 1), Adam state,
      ``ada_p`` as given.
    * ``inputs``: (real images in [-1, 1], None, z, None, key), from seeds
      2 and 3, on ``device``.

    Raises without CUDA unless ``device`` is 'cpu'."""
    device = resolve_device(device)
    run = train_run(batch, img_resolution, channel_base)
    g_cfg, d_cfg, cfg, aug_cfg = (run.g_cfg, run.d_cfg, run.train_cfg,
                                  run.augment_cfg)
    r1_d_cfg = dataclasses.replace(d_cfg, remat=True) if run.reg_remat else None
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
            do_g_reg=do_g, do_d_reg=do_d, reg_g_cfg=pl_g_cfg if do_g else None,
            reg_d_cfg=r1_d_cfg if do_d else None)
    gen = torch.Generator().manual_seed(2)
    res = g_cfg.img_resolution
    real = (torch.rand((batch, g_cfg.img_channels, res, res), generator=gen)
            * 2 - 1).to(device)
    z = torch.randn((batch, g_cfg.z_dim), generator=gen).to(device)
    return steps, state, (real, None, z, None, Rng(3))
