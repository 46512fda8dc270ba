"""Pruned StyleSpace-direction forward: a trained s-space adaptation
flattened to its StyleSpace delta vector (6048 dims at 1024^2), all but
the largest ``perc`` of it by magnitude zeroed, the same latents rendered
at each sparsity, one row each (port of examples/pruned_forward.py).
Without --network a random source generator of the checkpoint's embedded
config is used.

    python -m gagan_tpu_torch.examples.pruned_forward --ckpt sdelta.npz \
        [--network ffhq.npz] --outdir out [--percs 1.0,0.3,0.1,0.03] \
        [--device cuda]
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
from ..params import sparse
from ..utils.checkpoint import load_adaptation
from . import draw_latents, image_row, outdir, save
from .adaptation_inference import ensure_network


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="Adaptation npz with an s-space (s_delta) direction")
    ap.add_argument("--network", default=None)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--percs", default="1.0,0.3,0.1,0.03",
                    help="Comma-separated kept fractions")
    ap.add_argument("--n-latents", type=int, default=4)
    ap.add_argument("--truncation", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    network = ensure_network(args.network, args.ckpt, outdir(args.outdir))
    g_cfg, params = load_generator(network, device)
    _, offsets, _ = load_adaptation(args.ckpt, device)
    # The flat StyleSpace delta vector of an s-space parametrization.
    deltas = sparse.from_offsets(g_cfg.synthesis, offsets)
    total = int(deltas.shape[0])
    print(f"flat StyleSpace direction: {total} dims, "
          f"{int((deltas != 0).sum())} nonzero")
    z = draw_latents(args.seed, args.n_latents, g_cfg.z_dim, device)

    rows = []
    for keep in [float(p) for p in args.percs.split(",")]:
        # sparse.pruned zeros the smallest-|delta| fraction.
        pruned = sparse.pruned(deltas, 1.0 - keep)
        with torch.no_grad():
            img = sg2.generator_apply(
                g_cfg, params, z, truncation_psi=args.truncation,
                noise_mode="const",
                hooks=sparse.to_hooks(g_cfg.synthesis, pruned))
        rows.append(image_row(img))
        print(f"keep {keep:.2f}: kept {int((pruned != 0).sum())}/{total} dims")
    written: List[str] = []
    out = os.path.join(args.outdir, "pruned_sweep.png")
    save(out, np.concatenate(rows, axis=0), written)
    print(f"wrote {out} (rows = kept fractions {args.percs})")
    return written


if __name__ == "__main__":
    main()
