"""Style-mixing grids (port of gagan_tpu/cli/style_mixing.py).

    python -m gagan_tpu_torch.cli.style_mixing --network snap.npz \\
        --rows 85,100 --cols 55,821 --styles 0-6 --outdir out [--device cuda]

Each row seed's ``w`` takes the column seed's ``w`` at the ``--styles``
indices; writes ``{row}-{col}.png`` for every pair and each seed alone, and
``grid.png`` with the column seeds along the top and the row seeds down the
left.  ``z`` comes from ``np.random.RandomState(seed)`` as in the JAX CLI.
``--s-direction`` (repeatable) adds adaptation directions, each scaled by
its ``--s-scale`` (1.0 by default), as layer hooks of every synthesis.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import stylegan2 as sg2
from ..utils.png import write_png
from ..utils.rng import Rng
from . import num_range
from .generate import direction_hooks, load_generator, to_uint8


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Style-mixing grids from a gagan snapshot (PyTorch port).")
    ap.add_argument("--network", required=True, help="Snapshot .npz")
    ap.add_argument("--rows", dest="row_seeds", type=num_range, required=True)
    ap.add_argument("--cols", dest="col_seeds", type=num_range, required=True)
    ap.add_argument("--styles", dest="col_styles", type=num_range,
                    default="0-6")
    ap.add_argument("--trunc", dest="truncation_psi", type=float, default=1.0)
    ap.add_argument("--noise-mode", choices=["const", "random", "none"],
                    default="const")
    ap.add_argument("--s-direction", dest="s_directions", action="append",
                    default=None, help="StyleSpace direction npz (repeatable)")
    ap.add_argument("--s-scale", dest="s_scales", action="append",
                    type=float, default=None, help="Scale per direction")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    g_cfg, params = load_generator(args.network, device)
    hooks = None
    if args.s_directions:
        hooks = direction_hooks(args.s_directions, args.s_scales or [],
                                device)
    os.makedirs(args.outdir, exist_ok=True)
    row_seeds, col_seeds = args.row_seeds, args.col_seeds

    def synth(w):
        img = sg2.synthesis_apply(g_cfg.synthesis, params["synthesis"], w,
                                  noise_mode=args.noise_mode,
                                  generator=Rng(0), hooks=hooks)
        return to_uint8(img)

    with torch.no_grad():
        print("Generating W vectors...")
        all_seeds = list(dict.fromkeys(row_seeds + col_seeds))
        all_z = np.stack([np.random.RandomState(seed).randn(g_cfg.z_dim)
                          for seed in all_seeds])
        all_w = sg2.mapping_apply(g_cfg.mapping, params["mapping"],
                                  torch.from_numpy(all_z).float().to(device))
        w_avg = params["mapping"]["w_avg"]
        all_w = w_avg + (all_w - w_avg) * args.truncation_psi
        w_dict = dict(zip(all_seeds, all_w))

        print("Generating images...")
        image_dict = {}
        for seed, image in zip(all_seeds, synth(all_w)):
            image_dict[(seed, seed)] = image

        print("Generating style-mixed images...")
        for row_seed in row_seeds:
            for col_seed in col_seeds:
                w = w_dict[row_seed].clone()
                w[args.col_styles] = w_dict[col_seed][args.col_styles]
                image_dict[(row_seed, col_seed)] = synth(w[None])[0]

    print("Saving images...")
    for (row_seed, col_seed), image in image_dict.items():
        write_png(f"{args.outdir}/{row_seed}-{col_seed}.png", image)

    print("Saving image grid...")
    res = g_cfg.img_resolution
    canvas = np.zeros((res * (len(row_seeds) + 1),
                       res * (len(col_seeds) + 1), 3), np.uint8)
    for row_idx, row_seed in enumerate([0] + row_seeds):
        for col_idx, col_seed in enumerate([0] + col_seeds):
            if row_idx == 0 and col_idx == 0:
                continue
            key = (row_seed, col_seed)
            if row_idx == 0:
                key = (col_seed, col_seed)
            if col_idx == 0:
                key = (row_seed, row_seed)
            canvas[res * row_idx:res * (row_idx + 1),
                   res * col_idx:res * (col_idx + 1)] = image_dict[key]
    write_png(f"{args.outdir}/grid.png", canvas)


if __name__ == "__main__":
    main()
