"""Generate images from a snapshot (port of gagan_tpu/cli/generate.py, seeds
path).

    python -m gagan_tpu_torch.cli.generate --network snap.npz --seeds 0-3 \\
        --outdir out [--trunc 0.7] [--noise-mode const] [--device cuda]

Per-seed ``z`` comes from ``np.random.RandomState(seed)`` as in the JAX CLI,
so const-noise images match it.  PNGs are written by a small stdlib
(zlib/struct) encoder.  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import stylegan2 as sg2
from ..utils import checkpoint as ckpt
from ..utils import config as config_lib
from . import num_range


def write_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array as an 8-bit RGB PNG."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                          axis=1)                   # filter type 0 per row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


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


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Generate images from a gagan snapshot (PyTorch port).")
    ap.add_argument("--network", required=True, help="snapshot .npz")
    ap.add_argument("--seeds", type=num_range, required=True,
                    help="list of random seeds, e.g. 0,1,4-6")
    ap.add_argument("--trunc", dest="truncation_psi", type=float, default=1.0)
    ap.add_argument("--noise-mode", choices=["const", "random", "none"],
                    default="const")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    g_cfg, params = load_generator(args.network, device)
    if g_cfg.c_dim != 0:
        raise NotImplementedError("conditional generators are not ported yet")
    os.makedirs(args.outdir, exist_ok=True)

    with torch.no_grad():
        for seed_idx, seed in enumerate(args.seeds):
            print(f"Generating image for seed {seed} "
                  f"({seed_idx}/{len(args.seeds)}) ...")
            z = torch.from_numpy(
                np.random.RandomState(seed).randn(1, g_cfg.z_dim)).float()
            gen = torch.Generator(device).manual_seed(seed)
            img = sg2.generator_apply(
                g_cfg, params, z.to(device),
                truncation_psi=args.truncation_psi,
                noise_mode=args.noise_mode, generator=gen)
            write_png(os.path.join(args.outdir, f"seed{seed:04d}.png"),
                      to_uint8(img)[0])


if __name__ == "__main__":
    main()
