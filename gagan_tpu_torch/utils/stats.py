"""Training statistics: name-keyed moment accumulators + jsonl/TensorBoard
(port of gagan_tpu/utils/stats.py).

Each reported value accumulates [num, sum, sum-of-squares] per name; the
metric names are the JAX package's (``Loss/G/loss``, ``Loss/signs/real``,
``Progress/kimg``, ``Timing/...``), so ``stats.jsonl`` lines of either
package read the same.  The loop hands :meth:`Collector.report_dict` a dict
of 0-d tensors once a step; they reach the host in one copy.  The
data-parallel step's metrics are already means over every rank, so the
loop's Collector takes no mesh; a Collector made with a rank's mesh is for
values that differ by rank, and sums [num, sum, sumsq] over the ranks when
a value is read, as the reference's ``training_stats`` does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .checkpoint import tree_to_flat_tensors


def to_host(values: List[Any]) -> List[np.ndarray]:
    """float64 numpy copies of ``values``; the tensors among them cross to
    the host in one device-to-host copy."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    host = []
    if tensors:
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                          for t in tensors]).cpu().numpy()
        offsets = np.cumsum([0] + [t.numel() for t in tensors])
        host = [flat[a:b].reshape(t.shape)
                for a, b, t in zip(offsets[:-1], offsets[1:], tensors)]
    it = iter(host)
    return [next(it) if isinstance(v, torch.Tensor)
            else np.asarray(v, dtype=np.float64) for v in values]


class Collector:
    """Accumulate [num, sum, sumsq] per metric name between ticks.

    With a sharded ``mesh`` (``parallel/mesh.py``) the values read are over
    every rank's reports: each read sums the moments over the ranks in one
    all_reduce, a collective that every rank makes with the same names."""

    def __init__(self, mesh=None):
        self._moments: Dict[str, list] = {}
        self._mesh = mesh if mesh is not None and mesh.sharded else None

    def report(self, name: str, value) -> None:
        arr = to_host([value])[0].reshape(-1)
        m = self._moments.setdefault(name, [0, 0.0, 0.0])
        m[0] += arr.size
        m[1] += float(arr.sum())
        m[2] += float(np.square(arr).sum())

    def _read(self) -> Dict[str, list]:
        if self._mesh is None or not self._moments:
            return self._moments
        names = sorted(self._moments)
        t = torch.tensor([self._moments[n] for n in names],
                         dtype=torch.float64, device=self._mesh.device)
        rows = self._mesh.all_reduce_(t).tolist()
        return {n: [int(r[0]), r[1], r[2]] for n, r in zip(names, rows)}

    @staticmethod
    def _mean(m) -> float:
        return m[1] / m[0] if m and m[0] else 0.0

    @staticmethod
    def _std(m) -> float:
        if not m or m[0] == 0:
            return 0.0
        mean = m[1] / m[0]
        return float(np.sqrt(max(m[2] / m[0] - mean * mean, 0.0)))

    def report_dict(self, metrics: Dict) -> None:
        names = [k for k in metrics if not k.startswith("aux/")]
        for k, v in zip(names, to_host([metrics[k] for k in names])):
            self.report(k, v)

    def mean(self, name: str, default: float = 0.0) -> float:
        m = self._read().get(name)
        return self._mean(m) if m and m[0] else default

    def std(self, name: str) -> float:
        return self._std(self._read().get(name))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"num": m[0], "mean": self._mean(m), "std": self._std(m)}
                for name, m in self._read().items()}

    def reset(self) -> None:
        self._moments.clear()


class StatsLogger:
    """stats.jsonl + optional TensorBoard scalars + optional wandb backend.

    TensorBoard is ``torch.utils.tensorboard`` when it imports, else off.
    wandb activates when ``use_wandb`` is true (or the GAGAN_WANDB env var is
    set) AND the package imports; otherwise the backend is a no-op with a
    one-line notice rather than a failure.
    """

    def __init__(self, run_dir: str, use_tensorboard: bool = True,
                 use_wandb: Optional[bool] = None,
                 wandb_project: str = "gagan_tpu",
                 config: Optional[Dict] = None):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self._jsonl = open(os.path.join(run_dir, "stats.jsonl"), "at")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils import tensorboard

                self._tb = tensorboard.SummaryWriter(run_dir)
            except Exception:
                self._tb = None
        self._wandb = None
        if use_wandb is None:
            use_wandb = bool(os.environ.get("GAGAN_WANDB"))
        if use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project,
                           name=os.path.basename(run_dir.rstrip("/")),
                           dir=run_dir, config=config or {})
                self._wandb = wandb
            except Exception as e:
                print(f"[stats] wandb requested but unavailable ({e}); "
                      f"continuing with jsonl/TensorBoard only")

    def write(self, collector: Collector, step: int,
              extra: Optional[Dict[str, float]] = None) -> None:
        stats = collector.as_dict()
        if extra:
            for k, v in extra.items():
                stats[k] = {"num": 1, "mean": float(v), "std": 0.0}
        payload = {k: v["mean"] for k, v in stats.items()}
        payload["timestamp"] = time.time()
        self._jsonl.write(json.dumps(payload) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for name, v in stats.items():
                self._tb.add_scalar(name, v["mean"], global_step=step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log({k: v["mean"] for k, v in stats.items()},
                            step=step)

    def log_images(self, images, step: int, name: str = "images") -> None:
        """Image logging to wandb; a no-op without it (the training loop
        writes PNG grids to the run dir regardless)."""
        if self._wandb is None:
            return
        arr = np.asarray(images)
        self._wandb.log({name: [self._wandb.Image(a) for a in arr]},
                        step=step)

    def log_histograms(self, trees: Dict[str, Any], step: int) -> None:
        """Per-parameter TensorBoard histograms, named
        '<tree>/<dotted.path>'.  No-op without TensorBoard."""
        if self._tb is None:
            return
        for tree_name, tree in trees.items():
            for name, leaf in tree_to_flat_tensors(tree).items():
                try:
                    self._tb.add_histogram(
                        f"{tree_name}/{name}",
                        leaf.detach().float().cpu().numpy(), global_step=step)
                except Exception:
                    pass
        self._tb.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
