"""Compute quality metrics of a saved snapshot (port of
gagan_tpu/cli/calc_metrics.py).

    python -m gagan_tpu_torch.cli.calc_metrics --network snap.npz \\
        --metrics fid50k_full,kid50k_full --data <folder or zip> \\
        [--mirror] [--cache-dir DIR] [--batch 16] [--verbose] [--device cuda]

Each metric's result is printed as a JSON line and appended to
``metric-<name>.jsonl`` beside the snapshot.  The detectors' weights come
from ``GAGAN_DETECTOR_DIR`` (``inception_v3.npz``, ``vgg16.npz``); without
it they are random towers of the real shape and a warning says so on
stderr.  Dataset statistics are cached under ``--cache-dir``.  Runs on
CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .. import resolve_device

RANDOM_DETECTOR_WARNING = (
    "WARNING: feature detectors are deterministic RANDOM towers "
    "(GAGAN_DETECTOR_DIR unset or missing converted weights).  Metric "
    "machinery runs, but the reported values are NOT canonical FID/KID/etc. "
    "and are not comparable to published numbers.")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Calculate quality metrics for a trained snapshot.")
    ap.add_argument("--network", required=True, help="Snapshot .npz")
    ap.add_argument("--metrics", default="fid50k_full",
                    help="Comma-separated metric names (default "
                         "fid50k_full)")
    ap.add_argument("--data", default=None, help="Dataset (dir or zip)")
    ap.add_argument("--mirror", action="store_true")
    ap.add_argument("--cache-dir", default="~/.cache/gagan_tpu_metrics")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Runs the command; returns the result dicts."""
    from ..data import ImageFolderDataset
    from ..metrics import calc_metric, is_valid_metric, metric_main
    from ..metrics import detectors as det_lib
    from .generate import load_generator

    ap = build_parser()
    args = ap.parse_args(argv)
    metric_list = args.metrics.split(",")
    for m in metric_list:
        if not is_valid_metric(m):
            ap.error(f"Unknown metric: {m}. Valid: "
                     f"{metric_main.list_valid_metrics()} or fid<N>k")
    device = resolve_device(args.device)

    probe = det_lib.make_default("inception", device)
    if probe.name.endswith("-random"):
        print(RANDOM_DETECTOR_WARNING, file=sys.stderr, flush=True)

    g_cfg, params = load_generator(args.network, device)
    dataset = (ImageFolderDataset(args.data, xflip=args.mirror)
               if args.data else None)

    run_dir = os.path.dirname(args.network) or "."
    detectors = {"inception": probe}
    results = []
    for m in metric_list:
        result = calc_metric(
            m, g_params=params, g_cfg=g_cfg, dataset=dataset,
            detectors=detectors, cache_dir=os.path.expanduser(args.cache_dir),
            batch_size=args.batch, verbose=args.verbose, device=device)
        results.append(metric_main.report_metric(
            result, run_dir=run_dir, snapshot_pkl=args.network))
    return results


if __name__ == "__main__":
    main()
