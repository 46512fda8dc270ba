"""Quick start: a paper grid of faces from a StyleGAN2 snapshot (port of
examples/quick_start.py).  Without --network the weights are random
(torch seed 0) at --res (a layout demo).

    python -m gagan_tpu_torch.examples.quick_start --outdir out \
        [--network ffhq.npz] [--seeds 0-15] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from .. import resolve_device
from ..models import stylegan2 as sg2
from ..utils.image_utils import construct_paper_image_grid
from . import numpy_latents, outdir, save


def load_generator(network: Optional[str], res: int, device):
    """(config, parameters) of a snapshot's generator, or of a random one
    at ``res``^2 with the default config."""
    if network:
        from ..cli.generate import load_generator as load
        return load(network, device)
    cfg = sg2.GeneratorConfig(z_dim=512, w_dim=512, img_resolution=res,
                              img_channels=3)
    return cfg, sg2.init_generator(cfg, torch.Generator().manual_seed(0),
                                   device)


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--network", default=None, help="snapshot .npz")
    ap.add_argument("--outdir", default="out")
    ap.add_argument("--seeds", default="0-15")
    ap.add_argument("--trunc", type=float, default=0.7)
    ap.add_argument("--res", type=int, default=256,
                    help="resolution for the random-weights demo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, params = load_generator(args.network, args.res, device)
    lo, hi = (args.seeds.split("-") + [args.seeds])[:2]
    z = numpy_latents(range(int(lo), int(hi) + 1), cfg.z_dim, device)
    with torch.no_grad():
        imgs = sg2.generator_apply(cfg, params, z, truncation_psi=args.trunc)
    grid = construct_paper_image_grid(imgs[:16])
    written: List[str] = []
    out = os.path.join(outdir(args.outdir), "quick_start_grid.png")
    save(out, grid, written)
    print(f"wrote {out} ({grid.shape[1]}x{grid.shape[0]})")
    return written


if __name__ == "__main__":
    main()
