"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``: a model
configuration (``portbench/configs/<config>.json``) under a traffic mix
(``portbench/traffic/<traffic>.json``), whose ``job`` names the module
under ``portbench/jobs/`` that builds the program's job, warms it up,
runs the measured window and checks what the window produced against the
plain reference.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` runs the window under ``torch.profiler`` and reports its
per-layer metrics, each read by ``portbench/layers/<metric>.py``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` and, traced, a
``breakdown``); the numbers compared with the reference are printed last
on standard error, each beside its limit.  Without enough CUDA devices,
without the benchmark's files, or with JAX loaded, the run exits non-zero
and prints no result.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness

    try:
        cell = harness.load_cell(ROOT, args.workload)
    except harness.SetupError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    harness.keep_caches_in(ROOT)
    import importlib.util

    if importlib.util.find_spec("gagan_tpu_torch") is None:
        print("portbench: the package under test, gagan_tpu_torch, is not "
              "in this checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              t0=T0, device="cuda")
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the process holds {', '.join(loaded)} after the "
              f"window; the port must run without JAX", file=sys.stderr)
        return 4
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
