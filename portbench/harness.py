"""The benchmark's machinery: finding a cell's files by name, the measured
window (host clock, and ``torch.profiler`` when traced), the reduction of
the trace to per-layer readings, the correctness verdict and the result
line.  What one kind of job does lives in ``portbench/jobs/<job>.py``;
what one per-layer metric reads lives in ``portbench/layers/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 outside them,
# HBM3 bandwidth.  Every roofline and mfu of the benchmark is against these.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12

# Top-level modules that must not be loaded in a run (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "gagan_tpu")


class SetupError(Exception):
    """The benchmark's files do not describe the cell asked for."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    home: str                       # the checkout's portbench/


def _read_json(path: str, what: str) -> Any:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise SetupError(f"cannot read {what} {path}: {e}") from e


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration
    and traffic files, and the metrics it reports."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"), "the benchmark")
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    if name not in cells:
        raise SetupError(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench.get("configs", [])}
    if w["config"] not in configs:
        raise SetupError(f"{name}: no config {w['config']!r}")
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]),
                        "the config")
    traffic = _read_json(os.path.join(root, "portbench", "traffic",
                                      w["traffic"] + ".json"),
                         "the traffic mix")
    e2e = [m for m in bench.get("end_to_end", [])
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layers = [m for m in bench.get("per_layer", [])
              if (name in m["workloads"] if "workloads" in m
                  else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"],
                traffic, e2e, layers, os.path.join(root, "portbench"))


def keep_caches_in(root: str) -> None:
    """Every kernel cache at a fixed path inside the checkout.  The port
    builds its own kernels under ``gagan_tpu_torch/build/``."""
    cache = os.path.join(root, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> List[str]:
    """The top-level names in ``sys.modules`` that must not be there."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise SetupError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------------
# A run


@dataclasses.dataclass
class Check:
    """One number compared with the reference and its limit (a reading at
    or below the limit passes)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a job hands back: the work attempted and failed in the
    window, its end-to-end values by metric name, the work the per-layer
    readers count (``work``), and the comparisons with the reference."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    work: Dict[str, Any]
    checks: List[Check]


class Run:
    """One run of a cell: the seed, the window's length, the device, and
    the window itself (``start_window`` / ``end_window``, both called at
    points where the device has finished the work queued before them)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 t0: float, device: str = "cuda",
                 overrides: Optional[Dict[str, Any]] = None):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.t0, self.device = trace, t0, device
        # Test-only changes of the config and traffic (tiny CPU runs).
        self.overrides = overrides or {}
        self.config = {**cell.config, **self.overrides.get("config", {})}
        self.traffic = {**cell.traffic, **self.overrides.get("traffic", {})}
        self.window_start: Optional[float] = None
        self.window_s: Optional[float] = None
        self.setup_s: Optional[float] = None
        self.memory_peak_bytes = 0
        self.window_peak_bytes = 0
        # Set-up by part: seconds from the previous mark (or process
        # start) to each ``mark``; the last part, "warm", ends where the
        # window starts, so the parts add up to ``setup_s``.
        self.setup_parts: Dict[str, float] = {}
        self.compiled = False
        self._last_mark = t0
        self._prof = None
        self.trace_reading: Optional["TraceReading"] = None

    @property
    def window_seconds(self) -> float:
        """The window's length: ``--seconds``, or traced, the mix's
        ``trace_seconds`` where that is shorter (a profiler trace of a long
        window of short kernels holds millions of events, and the run has
        to end in time)."""
        if self.trace and "trace_seconds" in self.traffic:
            return min(self.seconds, float(self.traffic["trace_seconds"]))
        return self.seconds

    @property
    def on_cuda(self) -> bool:
        return str(self.device).startswith("cuda")

    def _sync(self):
        if self.on_cuda:
            import torch

            torch.cuda.synchronize()

    def mark(self, part: str) -> None:
        """End the set-up part ``part`` now."""
        now = time.time()
        self.setup_parts[part] = (self.setup_parts.get(part, 0.0)
                                  + now - self._last_mark)
        self._last_mark = now

    def start_window(self) -> None:
        import torch

        self._sync()
        if self.on_cuda:
            self.memory_peak_bytes = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        if self.trace and self.on_cuda:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.start()
        self.mark("warm")
        self.window_start = self._last_mark
        self.setup_s = self.window_start - self.t0

    def end_window(self) -> None:
        import torch

        self._sync()
        end = time.time()
        self.window_s = end - self.window_start
        if self._prof is not None:
            self._prof.stop()
        if self.on_cuda:
            self.window_peak_bytes = torch.cuda.max_memory_allocated()
            self.memory_peak_bytes = max(self.memory_peak_bytes,
                                         self.window_peak_bytes)

    def reduce_trace(self) -> None:
        """Reduce the window's profile (after the job has read what it
        needs from the program); frees the profiler."""
        if self._prof is not None:
            self.trace_reading = TraceReading.from_profile(self._prof,
                                                           self.window_s)
            self._prof = None


# ----------------------------------------------------------------------------
# The trace (the arithmetic of chip_smoke.py::trace_window)

FUSED_FWD_KERNELS = ("fold_taps_kernel", "modconv_bf16_kernel",
                     "modconv_fp32_kernel")
BWD_RANGE = "fused_modconv3x3_bwd"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


@dataclasses.dataclass
class TraceReading:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    ranges_s: Dict[str, float]
    launches: int
    idle_gaps: List[Tuple[str, float]]

    @classmethod
    def from_profile(cls, prof, window_s: float) -> "TraceReading":
        import torch

        kernel_us: Dict[str, float] = {}
        spans, cpu = [], []
        ranges_us: Dict[str, float] = {}
        launches = 0
        for evt in prof.events():
            tr = evt.time_range
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                if evt.name == BWD_RANGE:
                    continue
                kernel_us[evt.name] = (kernel_us.get(evt.name, 0.0)
                                       + tr.elapsed_us())
                spans.append((tr.start, tr.end))
                continue
            if evt.name == BWD_RANGE:
                ranges_us[evt.name] = (ranges_us.get(evt.name, 0.0)
                                       + _device_total(evt))
            elif evt.name in LAUNCH_CALLS:
                launches += 1
            cpu.append((tr.start, tr.end, evt.name))
        busy, end, gaps = 0.0, -math.inf, []
        for start, stop in sorted(spans):          # union of the device spans
            if stop > end:
                if end > -math.inf and start > end:
                    gaps.append((end, start))
                busy += stop - max(start, end)
                end = stop
        return cls(window_s=window_s, busy_s=busy / 1e6,
                   kernel_s={k: v / 1e6 for k, v in kernel_us.items()},
                   ranges_s={k: v / 1e6 for k, v in ranges_us.items()},
                   launches=launches, idle_gaps=_gaps_by_host(gaps, cpu))

    def fused_forward_s(self) -> float:
        return sum(s for name, s in self.kernel_s.items()
                   if any(k in name for k in FUSED_FWD_KERNELS))

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps[:10]]}


def _device_total(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _gaps_by_host(gaps, cpu, keep: int = 2000) -> List[Tuple[str, float]]:
    """The device's idle gaps (the longest ``keep``), summed by the
    innermost host event running at each gap's middle (the profiler's
    CPU-side events: ops, ranges, runtime calls)."""
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:keep]
    cpu = sorted(cpu)
    starts = [c[0] for c in cpu]
    import bisect

    by: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        best, best_len = "(no host event)", math.inf
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(i - 4000, -1), -1):
            s, e, name = cpu[j]
            if e >= mid and e - s < best_len:
                best, best_len = name, e - s
        by[best] = by.get(best, 0.0) + (g1 - g0) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])


@dataclasses.dataclass
class Reading:
    """What a per-layer reader gets: the traced window's reduction, the
    job's count of the work done in it, the window's memory peak."""
    trace: TraceReading
    work: Dict[str, Any]
    window_peak_bytes: int


def read_layers(cell: Cell, reading: Reading) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in cell.per_layer:
        mod = load_module(os.path.join(cell.home, "layers", m["name"] + ".py"),
                          "portbench_layer_" + m["name"].replace(".", "_"))
        value = mod.read(reading)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ----------------------------------------------------------------------------
# The cell, end to end


def device_info(run: Run) -> Dict[str, Any]:
    import torch

    if run.on_cuda:
        platform, kind = "gpu", torch.cuda.get_device_name(0)
    else:
        platform, kind = "cpu", "cpu (rehearsal, not a device measurement)"
    return {"platform": platform, "kind": kind, "count": run.cell.chips,
            "memory_peak_bytes": int(run.memory_peak_bytes)}


def build_port(run: Run) -> None:
    """Start the card, then build (the first run in a checkout) or load the
    port's compiled libraries (``gagan_tpu_torch/_build.py``: the CUDA
    kernels and the host libraries), before the job first calls them, so
    that set-up records the build apart (``setup_parts["build"]``,
    ``compiled``).  A port without that module's functions builds at first
    use instead, inside the "warm" part."""
    import glob

    import torch

    run.mark("start")
    if not run.on_cuda:
        return
    torch.zeros(1, device=run.device)
    run.mark("cuda_init")
    from gagan_tpu_torch import _build

    if not all(hasattr(_build, f) for f in ("CSRC_DIR", "HOST_FLAGS",
                                             "HOST_LIBS", "_lib_path",
                                             "build_all", "load",
                                             "load_host")):
        return
    kernels = sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")))
    hosts = sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cpp")))
    host_flags = _build.HOST_FLAGS + _build.HOST_LIBS
    run.compiled = not (
        all(os.path.exists(_build._lib_path(s)) for s in kernels)
        and all(os.path.exists(_build._lib_path(s, host_flags))
                for s in hosts))
    _build.build_all(kernels)
    for src in kernels:
        _build.load(os.path.splitext(os.path.basename(src))[0])
    for src in hosts:
        _build.load_host(os.path.splitext(os.path.basename(src))[0])
    run.mark("build")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda",
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build, warm up, measure and check one run of ``cell``; returns the
    result line's object, the numbers compared last under ``checks``."""
    run = Run(cell, seed, seconds, trace, t0, device, overrides)
    build_port(run)
    job = load_module(os.path.join(cell.home, "jobs",
                                   run.traffic["job"] + ".py"),
                      "portbench_job_" + run.traffic["job"])
    outcome: Outcome = job.run(run)
    result: Dict[str, Any] = {
        "correct": bool(outcome.checks) and all(c.ok for c in outcome.checks),
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
    }
    dev = device_info(run)
    if trace:
        reading = Reading(run.trace_reading or TraceReading(
            run.window_s or 0.0, 0.0, {}, {}, 0, []), outcome.work,
            run.window_peak_bytes)
        result["metrics"] = read_layers(cell, reading)
        dev["busy_s"] = reading.trace.busy_s
        dev["window_s"] = reading.trace.window_s
        result["breakdown"] = reading.trace.breakdown()
    else:
        values = dict(outcome.end_to_end, setup_s=run.setup_s)
        metrics = {}
        for m in cell.end_to_end:
            if values.get(m["name"]) is None:
                raise RuntimeError(f"{cell.name}: the job gave no "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
        result["metrics"] = metrics
    result["device"] = dev
    result["setup_parts"] = dict(run.setup_parts)
    result["compiled"] = run.compiled
    # A reading that is not a number (a leaf the program lacks) prints as
    # 1e30, which no limit passes: JSON has no infinity.
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value)
                                 else 1e30, "limit": c.limit}
                        for c in outcome.checks}
    return result


def print_result(result: Dict[str, Any]) -> None:
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
