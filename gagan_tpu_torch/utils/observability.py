"""Tracing, profiling, and consistency checks (port of
gagan_tpu/utils/observability.py): shape assertions, the port's span
recorder (``trace_scope``, read by ``span_totals``), a profiler session with
a TensorBoard trace handler, parameter fingerprints and summaries, a NaN
guard and a cross-process consistency check."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

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


# ----------------------------------------------------------------------------
# Spans
#
# The port's one span recorder.  A span records only while a torch profiler
# is recording (or while ``recording(True)`` holds); otherwise entering and
# leaving it reads two flags and does nothing else.  A recorded span is a
# named host range in the profiler's trace (one CPU event, on the clock of
# the kernels) and one record in memory: its name, the enclosing recorded
# span on its thread, its host start and end, and with ``device`` a pair of
# CUDA events on the current stream, read only when totals are asked for.
# The profiler range is a function-scope record, not a ``record_function``
# user annotation: the profiler copies a user annotation onto the device
# timeline as a range over its kernels, and a trace reader that takes every
# device event for a kernel would count each span's range as busy time.

_PROFILER = torch.autograd.profiler     # ``_is_profiler_enabled``: a bool
_HostRange = torch._C._profiler._RecordFunctionFast

_forced = False
_records: List["SpanRecord"] = []
_local = threading.local()


def recording(on: bool) -> bool:
    """Record spans without a profiler while ``on`` (tests, and measuring
    the spans' own cost); returns the previous setting."""
    global _forced
    was, _forced = _forced, bool(on)
    return was


def is_recording() -> bool:
    """Whether spans record now (a profiler records, or ``recording(True)``
    holds); the port's byte and launch tallies of a traced window follow
    it too."""
    return _forced or _PROFILER._is_profiler_enabled


@dataclasses.dataclass
class SpanRecord:
    name: str
    parent: Optional[str]           # the enclosing recorded span's name
    start_ns: int                   # time.perf_counter_ns()
    end_ns: int = 0
    events: Optional[Tuple[Any, Any]] = None    # CUDA (start, end) events

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self) -> Optional[float]:
        """Stream time from the start event to the end event (kernels and
        any device idle between them); waits for the end event."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


def _stack() -> List[SpanRecord]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class trace_scope:
    """A named span over the enclosed work (see the section's comment).
    ``device``: also time the enclosed work on the card's current stream,
    when CUDA is in use.  Whether the span records is decided on entry."""

    __slots__ = ("name", "device", "_range", "_rec")

    def __init__(self, name: str, device: bool = False):
        self.name = name
        self.device = device
        self._rec = None

    def __enter__(self):
        if not (_forced or _PROFILER._is_profiler_enabled):
            return self
        self._range = _HostRange(self.name)
        self._range.__enter__()
        events = None
        if self.device and torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        stack = _stack()
        self._rec = SpanRecord(self.name, stack[-1].name if stack else None,
                               time.perf_counter_ns(), events=events)
        stack.append(self._rec)
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is None:
            return False
        self._rec = None
        rec.end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        _stack().pop()
        _records.append(rec)
        self._range.__exit__(*exc)
        return False


def traced(name: str, device: bool = False):
    """Decorator: each call of the function is a :class:`trace_scope`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with trace_scope(name, device):
                return fn(*args, **kwargs)
        return call
    return wrap


def span_records() -> List[SpanRecord]:
    """The recorded spans, in the order they ended."""
    return list(_records)


def span_totals() -> Dict[str, Dict[str, Any]]:
    """{name: {"count", "host_ms", "device_ms"}} over the recorded spans;
    ``device_ms`` sums the spans timed on the card, None where none was
    (on the CPU).  Waits for the card to reach each span's end."""
    out: Dict[str, Dict[str, Any]] = {}
    for rec in span_records():
        t = out.setdefault(rec.name, {"count": 0, "host_ms": 0.0,
                                      "device_ms": None})
        t["count"] += 1
        t["host_ms"] += rec.host_ms
        ms = rec.device_ms()
        if ms is not None:
            t["device_ms"] = (t["device_ms"] or 0.0) + ms
    return out


def reset_spans() -> None:
    """Forget the recorded spans."""
    _records.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the enclosed work (host, and the card when there is one) and
    write a trace that TensorBoard's profiler plugin reads
    (``tensorboard --logdir <log_dir>``): the port's spans appear in it as
    named host ranges beside the kernels."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


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
