"""Domain-adaptation inference: (source, adapted) pairs from a saved
adaptation checkpoint (port of examples/adaptation_inference.py).  Without
--network a random source generator of the checkpoint's embedded config
(torch seed 0) is written into --outdir first (an offline demo).

    python -m gagan_tpu_torch.examples.adaptation_inference \
        --ckpt adaptation.npz [--network ffhq.npz] --outdir out [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..inference import Inferencer
from ..models import stylegan2 as sg2
from ..utils.checkpoint import load_adaptation, save_snapshot
from ..utils.config import generator_config_from_dict, to_dict
from ..utils.image_utils import t2im
from . import outdir, save


def ensure_network(network: Optional[str], ckpt: str, out: str) -> str:
    """``network``, or a snapshot of a random G of ``ckpt``'s embedded
    config written into ``out``."""
    if network:
        return network
    meta, _, _ = load_adaptation(ckpt)
    if "sg2_params" not in meta:
        raise SystemExit("--network required: ckpt has no embedded config")
    cfg = generator_config_from_dict(meta["sg2_params"])
    params = sg2.init_generator(cfg, torch.Generator().manual_seed(0), "cpu")
    path = os.path.join(out, "source_random.npz")
    save_snapshot(path, g_ema=params, config={"g_cfg": to_dict(cfg)})
    print(f"(no --network: wrote random source generator to {path})")
    return path


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True, help="adaptation .npz")
    ap.add_argument("--network", default=None, help="source snapshot .npz")
    ap.add_argument("--outdir", default="out")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--trunc", type=float, default=0.7)
    ap.add_argument("--mtg-mixing", action="store_true",
                    help="MTG-style style_latents[7:] swap")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    network = ensure_network(args.network, args.ckpt, outdir(args.outdir))
    inf = Inferencer(args.ckpt, network, device=device)
    z = torch.as_tensor(np.random.RandomState(0).randn(args.n, inf.g_cfg.z_dim),
                        dtype=torch.float32, device=device)
    src, trg = inf(z, truncation=args.trunc, mtg_mixing=args.mtg_mixing)
    written: List[str] = []
    for i in range(args.n):
        pair = np.concatenate([t2im(src[i], 256), t2im(trg[i], 256)], axis=1)
        save(os.path.join(args.outdir, f"pair_{i:02d}.png"), pair, written)
    print(f"wrote {args.n} source/target pairs to {args.outdir}")
    return written


if __name__ == "__main__":
    main()
