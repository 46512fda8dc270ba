"""Generate images from a snapshot (port of gagan_tpu/cli/generate.py).

    python -m gagan_tpu_torch.cli.generate --network snap.npz --seeds 0-3 \\
        --outdir out [--trunc 0.7] [--noise-mode const] [--class 2] \\
        [--device cuda]
    python -m gagan_tpu_torch.cli.generate --network snap.npz \\
        --projected-w w.npz --outdir out

Per-seed ``z`` comes from ``np.random.RandomState(seed)`` as in the JAX CLI,
so const-noise images match it; ``--noise-mode random`` draws each seed's
noise from a generator seeded with the seed (torch cannot reproduce JAX's
numbers).  ``--projected-w`` replays the ``w`` [N, num_ws, w_dim] array of an
npz.  ``--s-direction`` / ``--s-scale`` (StyleSpace directions) are parsed
and refused: the offsets hooks are not ported yet (ROADMAP item 11).  PNGs
are written by utils/png.py.  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import stylegan2 as sg2
from ..utils import checkpoint as ckpt
from ..utils import config as config_lib
from ..utils.png import write_png
from ..utils.rng import Rng
from . import num_range


def to_uint8(img: torch.Tensor) -> np.ndarray:
    """[N, C, H, W] float image in [-1, 1] -> [N, H, W, C] uint8."""
    img = img.float().cpu().numpy().transpose(0, 2, 3, 1)
    return np.clip(img * 127.5 + 128, 0, 255).astype(np.uint8)


def load_generator(network: str, device):
    """(config, parameter tree on ``device``) of a snapshot's generator."""
    trees, config = ckpt.load_snapshot(network, device=device)
    params = trees.get("G_ema", trees.get("G"))
    if params is None:
        raise ValueError(f"{network} holds no generator (G_ema or G)")
    return config_lib.generator_config_from_dict(config["g_cfg"]), params


def refuse_directions() -> None:
    """StyleSpace directions need the offsets hooks (ROADMAP item 11)."""
    raise NotImplementedError(
        "--s-direction / --s-scale (StyleSpace directions) need the offsets "
        "hooks, which are not ported yet (ROADMAP item 11)")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Generate images from a gagan snapshot (PyTorch port).")
    ap.add_argument("--network", required=True, help="Snapshot .npz")
    ap.add_argument("--seeds", type=num_range, default=None,
                    help="List of random seeds, e.g. 0,1,4-6")
    ap.add_argument("--trunc", dest="truncation_psi", type=float, default=1.0)
    ap.add_argument("--class", dest="class_idx", type=int, default=None)
    ap.add_argument("--noise-mode", choices=["const", "random", "none"],
                    default="const")
    ap.add_argument("--projected-w", default=None,
                    help="Replay projected W .npz")
    ap.add_argument("--s-direction", default=None,
                    help="StyleSpace direction (adaptation npz) to apply")
    ap.add_argument("--s-scale", type=float, default=1.0)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.s_direction is not None or args.s_scale != 1.0:
        refuse_directions()

    device = resolve_device(args.device)
    g_cfg, params = load_generator(args.network, device)
    if args.projected_w is None and args.seeds is None:
        ap.error("--seeds required without --projected-w")
    label = None
    if args.projected_w is None and g_cfg.c_dim != 0:
        if args.class_idx is None:
            ap.error("--class required for conditional nets")
        label = torch.zeros((1, g_cfg.c_dim), device=device)
        label[0, args.class_idx] = 1
    os.makedirs(args.outdir, exist_ok=True)

    with torch.no_grad():
        if args.projected_w is not None:
            ws = np.load(args.projected_w)["w"]
            if ws.shape[1:] != (g_cfg.num_ws, g_cfg.w_dim):
                raise ValueError(f"{args.projected_w}: w is {ws.shape}, not "
                                 f"[N, {g_cfg.num_ws}, {g_cfg.w_dim}]")
            for idx, w in enumerate(ws):
                img = sg2.synthesis_apply(
                    g_cfg.synthesis, params["synthesis"],
                    torch.from_numpy(np.asarray(w, np.float32))[None].to(
                        device), noise_mode=args.noise_mode,
                    generator=Rng(0))
                write_png(os.path.join(args.outdir, f"proj{idx:02d}.png"),
                          to_uint8(img)[0])
            return
        for seed_idx, seed in enumerate(args.seeds):
            print(f"Generating image for seed {seed} "
                  f"({seed_idx}/{len(args.seeds)}) ...")
            z = torch.from_numpy(
                np.random.RandomState(seed).randn(1, g_cfg.z_dim)).float()
            gen = torch.Generator(device).manual_seed(seed)
            img = sg2.generator_apply(
                g_cfg, params, z.to(device), c=label,
                truncation_psi=args.truncation_psi,
                noise_mode=args.noise_mode, generator=gen)
            write_png(os.path.join(args.outdir, f"seed{seed:04d}.png"),
                      to_uint8(img)[0])


if __name__ == "__main__":
    main()
