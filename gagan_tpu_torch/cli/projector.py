"""Project images into a generator's latent space (port of
gagan_tpu/cli/projector.py).

    python -m gagan_tpu_torch.cli.projector --network snap.npz \\
        --target img.png --outdir out --space w [--num-steps 1000] \\
        [--seed 303] [--truncation-psi 1] [--save-image] [--save-all-steps] \\
        [--save-n 10] [--device cuda]

A file or a directory of images (``.png``, ``.jpg``, ``.jpeg``, searched
recursively) is centre-cropped to a square and resized to the generator's
resolution with Lanczos-3 as Pillow's LANCZOS does; each image is optimised
into ``w`` or ``z`` space with the VGG16-LPIPS distance and the noise
penalty (inversion/projector.py), its draws from ``Rng(seed)``.  Writes
``projected_w.npz`` (key ``w``: the W+ latents stacked over the images),
with ``--save-image`` ``<stem>_proj.png`` (the re-synthesis) and
``<stem>_target.png``, with ``--save-all-steps`` ``<stem>_steps.npz`` (the
latent after every step) and every ``--save-n``-th step's frame under
``<stem>_steps/``.  PNG is read and written without Pillow; other formats
need it.  VGG16 weights come from ``GAGAN_DETECTOR_DIR/vgg16.npz``, else
random ones (metrics/detectors.py).  Runs on CUDA unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data.dataset import read_rgb
from ..inversion import projector
from ..models import stylegan2 as sg2
from ..ops.resize import resize_uint8
from ..utils.png import write_png
from ..utils.rng import Rng
from .generate import load_generator, to_uint8


def _load_targets(target_path: str,
                  resolution: int) -> Iterator[Tuple[str, np.ndarray]]:
    """(file name, [resolution, resolution, 3] uint8) of each target."""
    exts = (".png", ".jpg", ".jpeg")
    if os.path.isdir(target_path):
        files = sorted(f for f in glob.glob(target_path + "/**",
                                            recursive=True)
                       if f.lower().endswith(exts))
    else:
        files = [target_path]
    for fname in files:
        img = read_rgb(fname)
        h, w = img.shape[:2]
        s = min(w, h)
        top, left = (h - s) // 2, (w - s) // 2
        img = img[top:top + s, left:left + s]
        yield fname, resize_uint8(img, (resolution, resolution), "lanczos3")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Project images to the latent space of a snapshot "
                    "(PyTorch port).")
    ap.add_argument("--network", required=True, help="Snapshot .npz")
    ap.add_argument("--target", dest="target_fname", required=True,
                    metavar="FILE",
                    help="Target image file or directory to project")
    ap.add_argument("--num-steps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=303)
    ap.add_argument("--outdir", required=True, metavar="DIR")
    ap.add_argument("--space", required=True, choices=["w", "z"])
    ap.add_argument("--truncation-psi", type=float, default=1.0)
    ap.add_argument("--save-all-steps", action="store_true",
                    help="Save trajectory latents (and frames) for all images")
    ap.add_argument("--save-image", action="store_true",
                    help="Save the re-synthesized image per target")
    ap.add_argument("--save-n", type=int, default=10,
                    help="Stride between saved trajectory frames")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    return ap


def main(argv: Optional[List[str]] = None) -> List[Tuple[str, np.ndarray,
                                                         List[float]]]:
    """Project every target; returns (file name, W+ latents, the LPIPS
    distance of each step) per target."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    g_cfg, params = load_generator(args.network, device)
    os.makedirs(args.outdir, exist_ok=True)
    space = args.space

    def latent_to_ws(latent):
        latent = torch.as_tensor(latent, device=device)[None]
        if space == "z":
            return sg2.mapping_apply(g_cfg.mapping, params["mapping"], latent,
                                     truncation_psi=args.truncation_psi)
        return latent[:, None].expand(-1, g_cfg.num_ws, -1)

    def render(ws):
        with torch.no_grad():
            return to_uint8(sg2.synthesis_apply(
                g_cfg.synthesis, params["synthesis"], ws,
                noise_mode="const"))[0]

    results = []
    for idx, (fname, target) in enumerate(
            _load_targets(args.target_fname, g_cfg.img_resolution)):
        stem = os.path.splitext(os.path.basename(fname))[0]
        print(f"Projecting [{idx}] {fname} ({space}-space, {args.num_steps} "
              f"steps)", flush=True)
        dists: List[torch.Tensor] = []
        result = projector.project(
            g_cfg, params, target.transpose(2, 0, 1),
            num_steps=args.num_steps, space=space,
            truncation_psi=args.truncation_psi, rng=Rng(args.seed),
            verbose=True, return_trajectory=args.save_all_steps,
            on_step=lambda step, dist, grads: dists.append(dist))
        if args.save_all_steps:
            trajectory, w_plus = result
            np.savez(f"{args.outdir}/{stem}_steps.npz", **{space: trajectory})
            frame_dir = f"{args.outdir}/{stem}_steps"
            os.makedirs(frame_dir, exist_ok=True)
            for step in range(0, len(trajectory), max(args.save_n, 1)):
                with torch.no_grad():
                    ws = latent_to_ws(trajectory[step])
                write_png(f"{frame_dir}/step{step:05d}.png", render(ws))
        else:
            w_plus = result
        results.append((fname, w_plus,
                        torch.stack(dists).tolist() if dists else []))
        if args.save_image:
            write_png(f"{args.outdir}/{stem}_proj.png",
                      render(torch.as_tensor(w_plus, device=device)[None]))
            write_png(f"{args.outdir}/{stem}_target.png", target)

    np.savez(f"{args.outdir}/projected_w.npz",
             w=np.stack([w for _, w, _ in results]))
    print(f"Saved {len(results)} projected latents to "
          f"{args.outdir}/projected_w.npz")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
