"""Multiple and combined domain morphing from saved adaptation checkpoints
(port of examples/morphing.py): the trained offsets of one checkpoint
scaled from 0 to 1, or of two or more blended (a convex combination, then
all at once), each frame a row of latents.  Without --network a random
source generator of the first checkpoint's embedded config is used.

    python -m gagan_tpu_torch.examples.morphing --ckpt dom1.npz \
        [--ckpt dom2.npz ...] [--network ffhq.npz] --outdir out \
        [--frames 5] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..cli.generate import load_generator
from ..models import stylegan2 as sg2
from ..params import offsets as offs
from ..parallel.spatial import merge_hooks
from ..utils.checkpoint import load_adaptation
from . import draw_latents, image_row, outdir, save
from .adaptation_inference import ensure_network


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", action="append", required=True,
                    help="Adaptation npz (repeatable: 2+ = combined morph)")
    ap.add_argument("--network", default=None)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--n-latents", type=int, default=4)
    ap.add_argument("--truncation", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    network = ensure_network(args.network, args.ckpt[0], outdir(args.outdir))
    g_cfg, params = load_generator(network, device)
    domains = []
    for path in args.ckpt:
        meta, offsets, _ = load_adaptation(path, device)
        domains.append((offs.OffsetsSpec.from_string(meta["parametrization"]),
                        offsets))
    z = draw_latents(args.seed, args.n_latents, g_cfg.z_dim, device)
    written: List[str] = []

    def render(scales, name):
        # All domains share the source generator; their scaled offsets add
        # through the same hook slots.
        hooks = None
        for (spec, offsets), s in zip(domains, scales):
            h = offs.make_hooks(spec, sg2.tree_map(lambda t: t * s, offsets))
            hooks = h if hooks is None else merge_hooks(hooks, h)
        with torch.no_grad():
            img = sg2.generator_apply(g_cfg, params, z,
                                      truncation_psi=args.truncation,
                                      noise_mode="const", hooks=hooks)
        save(os.path.join(args.outdir, name), image_row(img), written)

    if len(domains) == 1:
        for fi, s in enumerate(np.linspace(0.0, 1.0, args.frames)):
            render([float(s)], f"morph_{fi:02d}.png")
            print(f"scale {s:.2f} -> morph_{fi:02d}.png")
    else:
        for fi, t in enumerate(np.linspace(0.0, 1.0, args.frames)):
            render([1.0 - t, float(t)] + [0.0] * (len(domains) - 2),
                   f"blend_{fi:02d}.png")
            print(f"blend {1 - t:.2f}/{t:.2f} -> blend_{fi:02d}.png")
        render([1.0] * len(domains), "combined.png")
        print("joint combination -> combined.png")
    return written


if __name__ == "__main__":
    main()
