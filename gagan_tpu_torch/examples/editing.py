"""Semantic editing: an InterFaceGAN direction sweep and a StyleSpace
channel edit (port of examples/editing.py).

    python -m gagan_tpu_torch.examples.editing --outdir out \
        [--network ffhq.npz] [--direction age.npz] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..editing.interfacegan import LatentEditor
from ..editing.stylespace import build_style_modification_hooks
from ..models import stylegan2 as sg2
from ..utils.image_utils import t2im
from . import numpy_latents, outdir, save
from .quick_start import load_generator


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--network", default=None)
    ap.add_argument("--outdir", default="out")
    ap.add_argument("--direction", default=None,
                    help=".npz W direction (random demo if absent)")
    ap.add_argument("--alphas", default="-3,0,3")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, params = load_generator(args.network, args.res, device)
    z = numpy_latents([1], cfg.z_dim, device)
    if args.direction:
        editor = LatentEditor.from_files({"edit": args.direction})
    else:
        d = np.random.RandomState(2).randn(cfg.w_dim)
        editor = LatentEditor({"edit": d / np.linalg.norm(d)})

    written: List[str] = []
    outdir(args.outdir)
    with torch.no_grad():
        ws = sg2.mapping_apply(cfg.mapping, params["mapping"], z)
        row = []
        for alpha in (float(a) for a in args.alphas.split(",")):
            edited = editor.apply_interfacegan(ws, "edit", alpha)
            img = sg2.synthesis_apply(cfg.synthesis, params["synthesis"],
                                      edited, noise_mode="const")
            row.append(t2im(img[0], size=256))
        save(os.path.join(args.outdir, "interfacegan_sweep.png"),
             np.concatenate(row, axis=1), written)

        # StyleSpace single-channel edit (layer 6, channel 10, +5.0).
        hooks = build_style_modification_hooks(cfg.synthesis,
                                               [((6, 10), 5.0, 1.0)])
        img = sg2.synthesis_apply(cfg.synthesis, params["synthesis"], ws,
                                  noise_mode="const", hooks=hooks)
    save(os.path.join(args.outdir, "stylespace_edit.png"),
         t2im(img[0], size=256), written)
    print(f"wrote edits to {args.outdir}")
    return written


if __name__ == "__main__":
    main()
