"""Tracing, profiling, and consistency checks (port of
gagan_tpu/utils/observability.py): shape assertions, named profiler spans,
a profiler session with a TensorBoard trace handler, phase timing that
synchronises the card, parameter fingerprints and summaries, a NaN guard and
a cross-process consistency check."""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict

import numpy as np
import torch

from .checkpoint import tree_to_flat, tree_to_flat_tensors


def assert_shape(x, ref_shape) -> None:
    """None entries are wildcards."""
    if x.ndim != len(ref_shape):
        raise AssertionError(
            f"Wrong number of dimensions: got {x.ndim}, "
            f"expected {len(ref_shape)}")
    for i, (size, ref) in enumerate(zip(x.shape, ref_shape)):
        if ref is not None and size != ref:
            raise AssertionError(
                f"Wrong size for dimension {i}: got {size}, expected {ref}")


@contextlib.contextmanager
def trace_scope(name: str):
    """Named profiler span."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the enclosed work (host, and the card when there is one) and
    write a trace that TensorBoard's profiler plugin reads
    (``tensorboard --logdir <log_dir>``); trace_scope spans appear as named
    regions."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class PhaseTimer:
    """Per-phase wall timing; with ``sync_on`` a CUDA tensor, the phase ends
    when the card has finished its work."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_on: Any = None):
        start = time.perf_counter()
        yield
        if isinstance(sync_on, torch.Tensor) and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        elapsed = time.perf_counter() - start
        self.totals[name] = self.totals.get(name, 0.0) + elapsed
        self.counts[name] = self.counts.get(name, 0) + 1

    def as_metrics(self) -> Dict[str, float]:
        return {f"Timing/{k}": v / max(self.counts[k], 1)
                for k, v in self.totals.items()}


def params_fingerprint(params) -> np.ndarray:
    """Cheap order-stable fingerprint of a tree (sum + sumsq per leaf, the
    leaves in sorted key order as JAX flattens a dict)."""
    vals = []
    flat = tree_to_flat(params)
    for key in sorted(flat, key=lambda k: k.split(".")):
        leaf = flat[key]
        arr = np.asarray(leaf, dtype=np.float64)
        vals.extend([arr.sum(), np.square(arr).sum()])
    return np.asarray(vals)


def check_cross_host_consistency(params, label: str = "params",
                                 mesh=None) -> None:
    """Every process must hold identical replicated parameters: their
    fingerprints are gathered over ``mesh``'s ranks (default: the
    initialised ``torch.distributed`` group; a no-op without one) by the
    mesh's all_reduce gather, which NCCL and gloo both run."""
    import torch.distributed as dist

    from ..parallel.mesh import create_mesh

    if mesh is None:
        if not (dist.is_available() and dist.is_initialized()):
            return
        mesh = create_mesh()
    if not mesh.sharded:
        return
    fp = torch.from_numpy(params_fingerprint(params)).to(mesh.device)
    every = mesh.gather(fp[None], [mesh.rank], mesh.world_size)
    if not bool((every == fp).all()):
        raise RuntimeError(f"{label}: cross-process parameter mismatch")


def summarize_params(params, name: str = "module") -> str:
    """Parameter-count table, grouped by top-level key."""
    flat = tree_to_flat(params)
    lines = [f"{name:<40s} {'shape':<20s} {'params':>12s}"]
    total = 0
    groups: Dict[str, int] = {}
    for key, arr in flat.items():
        total += arr.size
        top = key.split(".")[0]
        groups[top] = groups.get(top, 0) + arr.size
    for top, n in sorted(groups.items()):
        lines.append(f"{top:<40s} {'':<20s} {n:>12,d}")
    lines.append(f"{'Total':<40s} {'':<20s} {total:>12,d}")
    return "\n".join(lines)


def nan_guard(tree, label: str = "") -> bool:
    """True if any leaf contains non-finite values (debug helper)."""
    return any(not bool(torch.isfinite(torch.as_tensor(leaf)).all())
               for leaf in tree_to_flat_tensors(tree).values())
