#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gagan_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each raising on failure (the script then exits non-zero and prints
no ok line):
  1. device  - the card's name and power limit from nvidia-smi; no CUDA fails;
  2. build   - every kernel of the port from csrc/ with nvcc for sm_90a,
               with ptxas' registers / spills, the shared memory of each
               conv kernel and the count of wgmma (HGMMA) instructions in
               the SASS (cuobjdump, where the toolkit has it);
  3. kernels - each hand kernel against its plain PyTorch version on the card
               (KERNEL_CASES: the main path's shapes and edge cases, TF32
               off), timed beside its bound, its fold launch alone, the plain
               version and one cuDNN call;
  4. main    - the FFHQ-1024 generator forward through the port's entry point
               (pallas_level=True, random seeded weights, batch 8): kernel
               launch counts, output shape, finite values, agreement with the
               composed path; then imgs/s at batch 32 and one torch.profiler
               trace of a batch-32 forward (top kernels, fused levels' share);
  5. cli     - a 1024^2 snapshot through cli/generate.py for two seeds;
  6. a JSON line of the kernels, then the JSON ok line.
Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from gagan_tpu_torch import _build  # noqa: E402
from gagan_tpu_torch.cli import generate  # noqa: E402
from gagan_tpu_torch.entry import entry, entry_config  # noqa: E402
from gagan_tpu_torch.models import stylegan2 as sg2  # noqa: E402
from gagan_tpu_torch.ops import fused_modconv as fmc  # noqa: E402
from gagan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from gagan_tpu_torch.utils import config as config_lib  # noqa: E402

# Published dense peaks of the H100 SXM (NVIDIA data sheet, at 700 W):
# bf16 tensor-core FLOP/s, fp32 (non-tensor) FLOP/s, HBM bytes/s.
PEAKS = {"H100": (989e12, 67e12, 3.35e12)}
BATCH, TIMED_BATCH = 8, 32


class Case(NamedTuple):
    """One shape of the kernels phase."""
    label: str
    n: int
    c_in: int
    c_out: int
    h: int
    w: int
    dtype: torch.dtype
    on_path: bool = False          # a level of the main path
    noise: bool = True
    clamp: Optional[float] = 256.0
    demodulate: bool = True        # else dcoefs are ones


# The main path's two levels, the fp32 variant, and edge cases: ragged H,
# W and C_in off the 64-wide tile, several C_out tiles, no noise / clamp /
# demodulation.
KERNEL_CASES = (
    Case("b128.conv1", BATCH, 256, 256, 128, 128, torch.bfloat16, on_path=True),
    Case("b256.conv1", BATCH, 128, 128, 256, 256, torch.bfloat16, on_path=True),
    Case("b128.conv1 fp32", BATCH, 256, 256, 128, 128, torch.float32),
    Case("edge", 3, 48, 256, 7, 136, torch.bfloat16),
    Case("plain epilogue", 2, 128, 128, 32, 128, torch.bfloat16, noise=False,
         clamp=None, demodulate=False),
    Case("3 C_out tiles", 1, 256, 384, 16, 128, torch.bfloat16),
)


def phase(name):
    print(f"== {name}", flush=True)


def bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def time_ms(fn, iters=20, warmup=3) -> float:
    """Device time per call: the launches are queued behind a spin kernel,
    so that the host's time to enqueue them is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)      # ~10 ms of spinning at H100 clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_phase():
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test runs on a CUDA card only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in PEAKS.items() if k in name), None)
    if peaks is None:
        raise SystemExit(f"chip_smoke: no published peaks for {name!r}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    return card, peaks


def build_phase():
    phase("build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for src, lib in libs.items():
        with open(lib + ".log") as f:
            report = [ln.strip() for ln in f if "registers" in ln
                      or "spill" in ln or "Compiling entry" in ln
                      or "Performance" in ln or "warning" in ln]
        print(f"{src} -> {os.path.relpath(lib, REPO)}")
        for ln in report:
            print("  " + ln)
        if not os.path.exists(cuobjdump):
            print("  HGMMA count: not measured (no cuobjdump)")
            continue
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
        hmma = sum("HMMA" in ln for ln in sass.splitlines())
        print(f"  SASS: {hgmma} HGMMA (wgmma), {hmma} HMMA (mma.sync)")
        if src == "fused_modconv.cu" and (hgmma == 0 or hmma != 0):
            raise AssertionError("the bf16 kernel must issue wgmma, not mma.sync")
    for dt in (torch.bfloat16, torch.float32):
        print(f"fused_modconv conv kernel, {str(dt)[6:]}: "
              f"{fmc.smem_bytes(dt)} bytes of dynamic shared memory a block")
    print(f"build_s {build_s:.1f}")


def level_inputs(case: Case, seed: int, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    n, c_in, c_out, h, w = case.n, case.c_in, case.c_out, case.h, case.w
    x = randn(n, c_in, h, w).to(case.dtype)
    wt = randn(c_out, c_in, 3, 3)
    s = randn(n, c_in) * 0.3 + 1.0
    noise = randn(n, 1, h, w) * 0.1
    dcoefs = (fmc.demod_coefs(wt, s) if case.demodulate
              else torch.ones((n, c_out), device=device))
    return dict(x=x, w=wt, styles=s, dcoefs=dcoefs,
                noise=noise if case.noise else None, bias=randn(c_out) * 0.1)


def kernel_phase(peaks):
    """Each case of KERNEL_CASES: kernel vs plain, then times.  Tolerances:
    bf16, one bf16 ulp of max|y| (kernel and plain fold the taps to bf16 at
    the same places and sum in fp32, so they differ by summation order and
    may round one ulp apart); fp32, 1e-4 of max|y| (summation order over
    9 * C_in products)."""
    phase("kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peak_bf16, peak_f32, hbm = peaks
    main = dict(ms=0.0, fold_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                library_ms=0.0, max_abs_err=0.0, flop_ms=0.0, byte_ms=0.0)
    for i, case in enumerate(KERNEL_CASES):
        label, n, ci, co, h, w, dt = case[:7]
        if not fmc.supported_shape((n, ci, h, w), (co, ci, 3, 3)):
            raise AssertionError(f"{label}: outside the kernel's predicate")
        a = level_inputs(case, seed=100 + i)
        args = (a["x"], a["w"], a["styles"], a["dcoefs"], a["noise"], a["bias"])
        y = fmc.fused_modconv3x3(*args, clamp=case.clamp)
        ref = fmc.fused_modconv3x3_ref(*args, clamp=case.clamp)
        torch.cuda.synchronize()
        if y.dtype != dt or tuple(y.shape) != (n, co, h, w):
            raise AssertionError(f"{label}: got {y.dtype} {tuple(y.shape)}")
        peak = float(ref.float().abs().max())
        err = float((y.float() - ref.float()).abs().max())
        tol = bf16_ulp(peak) if dt == torch.bfloat16 else 1e-4 * peak
        if not (np.isfinite(err) and err <= tol):
            raise AssertionError(f"{label}: max_abs_err {err} > {tol}")

        xs = (a["x"] * a["styles"].to(dt)[:, :, None, None]).contiguous()
        wl = a["w"].to(dt)
        kernel_ms = time_ms(
            lambda: fmc.fused_modconv3x3(*args, clamp=case.clamp))
        fold_ms = time_ms(lambda: fmc.fold_taps(a["w"], a["styles"],
                                                a["dcoefs"], dt))
        plain_ms = time_ms(lambda: fmc.fused_modconv3x3_ref(
            *args, clamp=case.clamp), iters=5)
        library_ms = time_ms(lambda: torch.nn.functional.conv2d(
            xs, wl, padding=1))
        flops = 2.0 * n * co * ci * 9 * h * w
        nbytes = (a["x"].numel() * a["x"].element_size()           # x
                  + n * co * h * w * a["x"].element_size()         # y
                  + 4 * (a["w"].numel() + a["styles"].numel()
                         + a["dcoefs"].numel() + co
                         + (n * h * w if case.noise else 0)))
        peak_ops = peak_bf16 if dt == torch.bfloat16 else peak_f32
        bound_ms = 1e3 * max(flops / peak_ops, nbytes / hbm)
        bound_by = "operations" if flops / peak_ops >= nbytes / hbm else "bytes"
        print(f"{label}: x {n}x{ci}x{h}x{w} C_out {co} {str(dt)[6:]} "
              f"max|y| {peak:.4g} max_abs_err {err:.4g} (tol {tol:.4g}) "
              f"kernel_ms {kernel_ms:.4f} fold_ms {fold_ms:.4f} "
              f"plain_ms {plain_ms:.4f} "
              f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} "
              f"({bound_by}) kernel_tflops {flops / kernel_ms / 1e9:.1f}",
              flush=True)
        if case.on_path:
            main["ms"] += kernel_ms
            main["fold_ms"] += fold_ms
            main["plain_ms"] += plain_ms
            main["library_ms"] += library_ms
            main["bound_ms"] += bound_ms
            main["max_abs_err"] = max(main["max_abs_err"], err)
            main["flop_ms"] += 1e3 * flops / peak_ops
            main["byte_ms"] += 1e3 * nbytes / hbm
        del a, args, y, ref, xs
    return main


def seeded_weights(params, seed=0):
    """Non-zero noise strengths and conv/torgb biases (zero at init), so
    the kernel's noise and bias paths do real work."""
    g = torch.Generator().manual_seed(seed)

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == "noise_strength":
                v.copy_(torch.rand((), generator=g) * 0.25 + 0.05)
            elif k == "bias" and "affine" not in path:
                v.copy_(torch.randn(v.shape, generator=g) * 0.1)

    walk(params["synthesis"], ())
    return params


def expected_launches(cfg: sg2.GeneratorConfig, batch: int) -> int:
    """conv1 levels outside the packed last block that the predicate takes."""
    s = cfg.synthesis
    res = s.block_resolutions[:-1] if s.packed_last_block else s.block_resolutions
    return sum(fmc.supported_shape((batch, s.channels(r), r, r),
                                   (s.channels(r), s.channels(r), 3, 3))
               for r in res)


def main_phase(card):
    """The tolerance against the composed path: the two round at different
    places (the fused level rounds the folded taps once, the composed one
    rounds x*s, the conv output and each epilogue step to bf16), each of the
    two levels lands a few bf16 ulps apart and bf16 blocks downstream carry
    that on.  Held to 2^-5 relative RMS and 2^-3 of max|img| at most; a
    wrong kernel gives errors of order 100%."""
    phase("main path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    forward, (params, z) = entry("cuda", batch=BATCH)
    params = seeded_weights(params)
    cfg = entry_config()
    want = expected_launches(cfg, BATCH)
    if want != 2:
        raise AssertionError(f"predicate takes {want} FFHQ-1024 levels, not 2")

    fmc.fused_modconv3x3.launches = 0
    img = forward(params, z)
    torch.cuda.synchronize()
    launches = fmc.fused_modconv3x3.launches
    print(f"fused_modconv3x3 launches per forward: {launches} "
          f"(expected {want}: b128.conv1, b256.conv1)")
    if launches != want:
        raise AssertionError(f"{launches} kernel launches, expected {want}")
    if tuple(img.shape) != (BATCH, 3, 1024, 1024) or img.dtype != torch.float32:
        raise AssertionError(f"output {img.dtype} {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite output")

    plain_cfg = entry_config(pallas_level=False)
    with torch.no_grad():
        ref = sg2.generator_apply(plain_cfg, params, z, noise_mode="const")
    peak = float(ref.abs().max())
    diff = (img - ref).float()
    rel_rms = float(diff.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
    max_err = float(diff.abs().max())
    print(f"vs composed path: max|img| {peak:.4g} max_abs_err {max_err:.4g} "
          f"rel_rms {rel_rms:.4g}")
    if not (rel_rms <= 2 ** -5 and max_err <= 2 ** -3 * peak):
        raise AssertionError("fused and composed paths disagree")
    del img, ref, diff

    # Throughput with PyTorch's default math settings (TF32 convs allowed).
    torch.backends.cudnn.allow_tf32 = True
    zt = torch.randn((TIMED_BATCH, cfg.z_dim),
                     generator=torch.Generator().manual_seed(2)).cuda()
    rates = {}
    for label, c in (("fused", cfg), ("composed", plain_cfg)):
        def run():
            with torch.no_grad():
                return sg2.generator_apply(c, params, zt, noise_mode="const")
        ms = time_ms(run, iters=5, warmup=2)
        rates[label] = TIMED_BATCH / ms * 1e3
    torch.cuda.synchronize()
    print(f"FFHQ-1024 forward batch {TIMED_BATCH}: "
          f"{rates['fused']:.2f} imgs/s (pallas_level=True), "
          f"{rates['composed']:.2f} imgs/s (pallas_level=False) "
          f"on {card}")
    trace_forward(cfg, params, zt)
    return params, launches


def trace_forward(cfg, params, z, top=10):
    """One torch.profiler trace of a forward: the kernels with the most
    device time and the fused levels' share (fold + conv launches) of the
    device time of all kernels, copies and fills of that forward."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        sg2.generator_apply(cfg, params, z, noise_mode="const")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sg2.generator_apply(cfg, params, z, noise_mode="const")
            torch.cuda.synchronize()
    device_us = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device_us[evt.name] = (device_us.get(evt.name, 0.0)
                                   + evt.time_range.elapsed_us())
    total = sum(device_us.values())
    print(f"trace of one batch-{z.shape[0]} forward (pallas_level=True):")
    if total <= 0:
        print("  device time: not measured (the trace holds no CUDA kernels)")
        return
    for name, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:9.4f} ms {100 * us / total:6.2f}%  {name[:110]}")
    fused = sum(us for name, us in device_us.items()
                if "modconv_bf16_kernel" in name or "fold_taps_kernel" in name)
    print(f"  fused levels (fold + conv): {fused / 1e3:.4f} ms of "
          f"{total / 1e3:.4f} ms device time, {100 * fused / total:.2f}%")


def read_png(path):
    """(width, height, raw scanlines) of an 8-bit RGB PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    return size[0], size[1], zlib.decompress(idat)


def cli_phase(params):
    phase("cli")
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "ffhq1024.npz")
        ckpt.save_snapshot(snap, g_ema=params,
                           config={"g_cfg": config_lib.to_dict(entry_config())})
        out = os.path.join(tmp, "out")
        fmc.fused_modconv3x3.launches = 0
        generate.main(["--network", snap, "--seeds", "0,1", "--outdir", out])
        torch.cuda.synchronize()
        launches = fmc.fused_modconv3x3.launches
        names = sorted(os.listdir(out))
        if names != ["seed0000.png", "seed0001.png"]:
            raise AssertionError(f"cli wrote {names}")
        for name in names:
            w, h, raw = read_png(os.path.join(out, name))
            pixels = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)[:, 1:]
            if (w, h) != (1024, 1024) or pixels.std() == 0:
                raise AssertionError(f"{name}: {w}x{h}, std {pixels.std()}")
        print(f"cli: {names}, fused_modconv3x3 launches {launches}")
        if launches != 4:
            raise AssertionError(f"cli made {launches} kernel launches, not 4")


def main():
    card, peaks = device_phase()
    build_phase()
    k = kernel_phase(peaks)
    params, launches = main_phase(card)
    cli_phase(params)
    kernels = [dict(
        name="fused_modconv3x3", route="cuda",
        source="gagan_tpu_torch/csrc/fused_modconv.cu",
        replaces="gagan_tpu/ops/pallas_modconv.py:76",
        launches=launches, max_abs_err=k["max_abs_err"], ms=k["ms"],
        fold_ms=k["fold_ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by="operations" if k["flop_ms"] >= k["byte_ms"] else "bytes",
        library_ms=k["library_ms"])]
    print(f"(kernel times: the launches of one batch-{BATCH} forward, "
          f"b128.conv1 + b256.conv1, on {card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
