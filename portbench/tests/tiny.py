"""Tiny CPU runs of the benchmark's cells: the cell's files with the
widths and batch cut so that a run takes seconds, and optionally the
program in float32 (so that a sound run reads nearly nothing against the
reference)."""

from __future__ import annotations

import dataclasses
import time

from portbench import harness
from tests_root import ROOT  # noqa: F401  (sets sys.path)

CONFIG = {"img_resolution": 32, "channel_base": 256, "channel_max": 32,
          "z_dim": 32, "w_dim": 32, "mapping_layers": 2,
          "clip_vit_b32": {"embed_dim": 32, "image_resolution": 32,
                           "vision_layers": 2, "vision_width": 64,
                           "vision_patch_size": 8, "vision_heads": 4}}
TRAFFIC = {"images": 12, "batch": 8, "rounds": [1, 1, 1], "reg_remat": False,
           "tick_batches": 1, "warm_batches": 5, "cycle_batches": 4,
           "warmup": 1, "warm_steps": 4}


def overrides(fp32: bool = True):
    def plan(p):
        g, d = p.g_cfg, p.d_cfg
        nf = 0 if fp32 else g.synthesis.num_fp16_res
        aug = p.augment_cfg
        return dataclasses.replace(
            p, g_cfg=dataclasses.replace(
                g, z_dim=CONFIG["z_dim"], w_dim=CONFIG["w_dim"],
                mapping=dataclasses.replace(
                    g.mapping, num_layers=CONFIG["mapping_layers"]),
                synthesis=dataclasses.replace(
                    g.synthesis, channel_base=CONFIG["channel_base"],
                    channel_max=CONFIG["channel_max"], num_fp16_res=nf)),
            d_cfg=dataclasses.replace(d, channel_base=CONFIG["channel_base"],
                                      channel_max=CONFIG["channel_max"],
                                      num_fp16_res=nf),
            augment_cfg=(dataclasses.replace(aug, compute_dtype=None)
                         if fp32 else aug))

    config = dict(CONFIG)
    if fp32:
        config["num_fp16_res"] = 0
    def adapt_cfg(a):
        return dataclasses.replace(a, clip_dtype="float32") if fp32 else a

    return {"config": config, "traffic": dict(TRAFFIC), "plan": plan,
            "adapt_cfg": adapt_cfg}


def run(cell_name: str, seed: int = 2 ** 31 + 17, seconds: float = 1.0,
        fp32: bool = True, trace: bool = False):
    cell = harness.load_cell(ROOT, cell_name)
    return harness.run_cell(cell, seed, seconds, trace, time.time(),
                            device="cpu", overrides=overrides(fp32))
