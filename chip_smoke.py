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
               version and one cuDNN call; at the main path's two levels also
               the level's backward against autograd through the plain
               version in fp32, timed alone and with the forward;
  4. main    - the FFHQ-1024 generator forward through the port's entry point
               (pallas_level=True, random seeded weights, batch 8): kernel
               launch counts, output shape, finite values, agreement with the
               composed path; then imgs/s at batch 32 and one torch.profiler
               trace of a batch-32 forward (top kernels, fused levels' share);
  5. cli     - a 1024^2 snapshot through cli/generate.py for two seeds;
  6. train   - the adversarial train step at FFHQ-1024, global batch 32
               (gagan_tpu_torch.entry.train_entry): the three scheduled
               variants, each checked (finite metrics, state moved, kernel
               launches) then timed with its peak memory, the s/kimg of the
               schedule, one GA Dmain round, pallas vs composed gradients of
               one main round (TF32 off), one torch.profiler trace of a step;
  7. loop    - a training run as users start it, at FFHQ-1024 on 32 random
               1024^2 PNGs (gagan_tpu_torch.cli.train, --cfg auto --batch 32
               --kimg 1: 32 batches, R1 with a remat'd D): stats.jsonl, the
               image grid, the network snapshot, the fused launches, the
               loop's own sec/kimg and its wait on the loader; the PNG
               decode rate (filter 0 and Paeth) on this host;
  8. remat   - one Gmain+Dmain round and one R1 round at live batch 8 (TF32
               off) with G and D remat'd and not: gradients against each
               other, times, peak memory, fused launches;
  9. cli     - on the loop's snapshot: generate --projected-w and
               style_mixing, their PNGs and launch counts;
 10. adapt   - one-shot CLIP adaptation (StyleGAN-NADA td_single, s_delta
               offsets) at FFHQ-1024 with a random ViT-B/32 of the real shape
               and the byte tokenizer: cli/adapt.py on
               configs/td_nada_sdelta.yaml for 21 steps (losses.jsonl at
               steps 0, 10, 20, the step-20 checkpoint, 2 fused launches a
               step, the level's backward asked for no weight gradient, the
               frozen G and CLIP without .grad); generate --s-direction
               (scale 0 byte-equal to plain generation, the trained offsets
               not); pallas vs composed offset gradients of one step (TF32
               off); steps/s of bench.py's adaptation shape (ViT-B/32 +
               ViT-B/16, batch 4, direction loss) in blocks of 10 steps with
               one sync each, its peak memory and a torch.profiler trace of
               a step (top kernels, fused share, share with no kernel);
 11. a JSON line of the kernels, then the JSON ok line.
Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from gagan_tpu_torch import _build  # noqa: E402
from gagan_tpu_torch.cli import adapt as adapt_cli  # noqa: E402
from gagan_tpu_torch.cli import generate, style_mixing  # noqa: E402
from gagan_tpu_torch.cli import train as train_cli  # noqa: E402
from gagan_tpu_torch.entry import (adapt_entry, entry,  # noqa: E402
                                   entry_config, train_configs, train_entry)
from gagan_tpu_torch.models import stylegan2 as sg2  # noqa: E402
from gagan_tpu_torch.ops import fused_modconv as fmc  # noqa: E402
from gagan_tpu_torch.train import augment, gan_loss  # noqa: E402
from gagan_tpu_torch.train import loop as loop_lib  # noqa: E402
from gagan_tpu_torch.train import train_step as ts  # noqa: E402
from gagan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from gagan_tpu_torch.utils import config as config_lib  # noqa: E402
from gagan_tpu_torch.utils import png  # noqa: E402

# Published dense peaks of the H100 SXM (NVIDIA data sheet, at 700 W):
# bf16 tensor-core FLOP/s, fp32 (non-tensor) FLOP/s, HBM bytes/s.
PEAKS = {"H100": (989e12, 67e12, 3.35e12)}
BATCH, TIMED_BATCH = 8, 32
TRAIN_BATCH = 32
# The three step variants a run schedules and their weights per 16 batches
# (Greg every 4, Dreg every 16): 12x none, 3x +Greg, 1x both.
SCHEDULE = {"none": 12, "greg": 3, "both": 1}
# The loop phase: a run of --kimg 1 at --batch 32 on this many 1024^2 PNGs.
LOOP_RES, LOOP_BATCH, LOOP_IMAGES, LOOP_KIMG = 1024, 32, 32, 1
REMAT_BATCH = 8
DEVICE = "cuda"
# The adapt phase: cli/adapt.py on this config for ADAPT_ITERS steps with a
# checkpoint every ADAPT_BACKUP and losses every ADAPT_LOG steps; timing in
# ADAPT_BLOCKS blocks of 10 steps.  ADAPT_CLIP_OVERRIDES shrinks the random
# towers (None: the real ViT-B shapes).
ADAPT_CONFIG = os.path.join("configs", "td_nada_sdelta.yaml")
ADAPT_ITERS, ADAPT_BACKUP, ADAPT_LOG = 21, 20, 10
ADAPT_BATCH, ADAPT_BLOCKS = 4, 3
ADAPT_CLIP_OVERRIDES = None


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
            bwd = backward_case(case, a, peaks)
            for k, v in bwd.items():
                main[k] = (max(main.get(k, 0.0), v) if k.endswith("err")
                           else main.get(k, 0.0) + v)
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


def backward_case(case: Case, a, peaks):
    """The level's backward on the card, against autograd through the plain
    version in fp32 on the same inputs and output gradient, TF32 off:

    (a) the composed backward run in fp32 (``fused_modconv3x3_bwd`` on fp32
        copies of the inputs): the same function summed in another order
        (about 1e-6 relative, measured on the CPU), except where a
        pre-activation lies so near 0 that the two orders disagree on its
        slope (a few elements in 10^7; measured on the card: about 4e-4
        relative L2): each such flip moves one pre-activation gradient by
        1.13 |g|, up to ~5 where max|g| ~ 4.5, which is up to 9% of
        max|dnoise| (one pixel's sum over the channels).  Bound, for each
        of the six gradients: relative L2 error <= 2^-8 and max-abs error
        <= 2^-3 of its max|.|;
    (b) the main path's bf16 route (kernel forward, composed bf16
        backward): it rounds x*s, the weight, u, du and the transposed
        conv's output to bf16 (2^-9 relative each), and where the bf16 u
        puts a pre-activation on the other side of 0 than fp32 does (about
        0.2% of the elements: |ypre| under ~2^-8.5 of its spread), that
        element's slope flips between sqrt(2) and 0.2 sqrt(2).  Measured on
        the CPU at these widths: 3.4-3.5% relative L2 and up to 9% of
        max|.| max-abs (dnoise), 0.6% for ddcoefs.  Bound: relative L2
        <= 2^-3 and max-abs <= 2^-2 of max|.|; a wrong formula or layout
        errs by O(100%), and (a) holds the formula tightly.

    Times: the bf16 backward alone, forward + backward through autograd,
    and the plain fp32 forward + backward; the bound is the backward's
    three convolutions (u and dx in bf16 on the tensor cores, dW in fp32 as
    written) at the card's peaks, or its bytes (inputs read once, gradients
    written once)."""
    peak_bf16, peak_f32, hbm = peaks
    n, ci, co, h, w = case.n, case.c_in, case.c_out, case.h, case.w
    gen = torch.Generator(device="cuda").manual_seed(7)
    g = torch.randn((n, co, h, w), generator=gen, device="cuda").to(case.dtype)
    names = ("x", "w", "styles", "dcoefs", "noise", "bias")
    ins = [a[k].detach().clone().requires_grad_() for k in names]
    y = fmc.fused_modconv3x3(*ins, clamp=case.clamp)
    y.backward(g)
    ref_ins = [a[k].detach().float().clone().requires_grad_() for k in names]
    fmc.fused_modconv3x3_ref(*ref_ins, clamp=case.clamp).backward(g.float())
    f32 = fmc.fused_modconv3x3_bwd(*[t.detach() for t in ref_ins], g.float(),
                                   float(np.sqrt(2.0)), fmc.LRELU_SLOPE,
                                   case.clamp)
    torch.cuda.synchronize()
    worst, worst_l2 = 0.0, 0.0
    for name, t, r, c in zip(names, ins, ref_ins, f32):
        want = r.grad
        if t.grad.dtype != (case.dtype if name == "x" else torch.float32):
            raise AssertionError(f"d{name} is {t.grad.dtype}")
        peak = float(want.abs().max())
        errs = []
        for got in (c, t.grad.float()):
            errs += [float((got - want).abs().max()),
                     float((got - want).norm() / want.norm())]
        print(f"  {case.label} backward d{name}: max|.| {peak:.4g}; fp32 "
              f"max_abs_err {errs[0]:.4g} rel_l2 {errs[1]:.4g}; bf16 route "
              f"max_abs_err {errs[2]:.4g} rel_l2 {errs[3]:.4g}")
        if not (errs[0] <= 2 ** -3 * peak and errs[1] <= 2 ** -8
                and errs[2] <= 2 ** -2 * peak and errs[3] <= 2 ** -3):
            raise AssertionError(f"{case.label}: d{name} disagrees with the "
                                 f"fp32 autograd of the plain version")
        worst, worst_l2 = max(worst, errs[2] / peak), max(worst_l2, errs[3])
    del f32

    bwd_args = [a[k] for k in names]
    bwd_ms = time_ms(lambda: fmc.fused_modconv3x3_bwd(
        *bwd_args, g, float(np.sqrt(2.0)), fmc.LRELU_SLOPE, case.clamp))

    def fwd_bwd():
        fmc.fused_modconv3x3(*ins, clamp=case.clamp).backward(g)

    def plain_fwd_bwd():
        fmc.fused_modconv3x3_ref(*ref_ins, clamp=case.clamp).backward(
            g.float())

    fwd_bwd_ms = time_ms(fwd_bwd, iters=10)
    plain_ms = time_ms(plain_fwd_bwd, iters=3)
    conv = 2.0 * n * co * ci * 9 * h * w
    flop_s = 2 * conv / peak_bf16 + conv / peak_f32
    esize = a["x"].element_size()
    nbytes = (2 * n * ci * h * w * esize + n * co * h * w * esize    # x, dx, g
              + 4 * 2 * (co * ci * 9 + n * ci + n * co + co
                         + (n * h * w if case.noise else 0)))
    bound = 1e3 * max(flop_s, nbytes / hbm)
    print(f"  {case.label} backward: bwd_ms {bwd_ms:.4f} fwd_bwd_ms "
          f"{fwd_bwd_ms:.4f} plain fwd_bwd_ms {plain_ms:.4f} bwd_bound_ms "
          f"{bound:.4f} ({'operations' if flop_s >= nbytes / hbm else 'bytes'})",
          flush=True)
    return dict(bwd_ms=bwd_ms, fwd_bwd_ms=fwd_bwd_ms, bwd_plain_ms=plain_ms,
                bwd_bound_ms=bound, bwd_max_rel_err=worst,
                bwd_max_rel_l2_err=worst_l2)


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


def clone_tree(tree):
    return sg2.tree_map(lambda t: t.detach().clone(), tree)


def max_change(after, before) -> float:
    a, b = ckpt.tree_to_flat_tensors(after), ckpt.tree_to_flat_tensors(before)
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def round_grads(loss_fn, trees):
    """(loss, metrics, {key: grad}) of ``loss_fn()`` with respect to every
    leaf of ``trees`` ({name: param tree}); the leaves are flagged for
    autograd only meanwhile."""
    leaves = {f"{name}/{k}": t for name, tree in trees.items()
              for k, t in ckpt.tree_to_flat_tensors(tree).items()
              if not k.endswith(("w_avg", "noise_const"))}
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        loss, metrics = loss_fn()
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    return loss, metrics, {k: (g if g is not None else torch.zeros_like(t))
                           for (k, t), g in zip(leaves.items(), grads)}


def rel_l2(a, b, keys) -> float:
    num = sum(float((a[k].float() - b[k].float()).square().sum()) for k in keys)
    den = sum(float(b[k].float().square().sum()) for k in keys)
    return float(np.sqrt(num / den))


def train_phase(card):
    """The adversarial train step at FFHQ-1024, global batch 32, with the
    JAX training CLI's 1024^2 configuration (entry.train_configs): rounds of
    8 live samples (Greg 16), bf16 ADA pipe "bgc" at p = 0.2 (ADA starts at
    0, which would leave every transform off).  The checked and timed steps
    run with PyTorch's default math (TF32 convolutions on, TF32 matmuls off);
    the pallas-vs-composed gradient check runs with TF32 off."""
    phase("train")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    steps, state, inputs = train_entry("cuda", batch=TRAIN_BATCH, ada_p=0.2)
    g_cfg, d_cfg, cfg, aug_cfg = train_configs(TRAIN_BATCH)
    real, _, z, _, key = inputs
    live = cfg.batch_size // cfg.accum_rounds
    want = expected_launches(g_cfg, live) * cfg.accum_rounds
    print(f"rounds: main {cfg.accum_rounds}, g_reg {cfg.g_reg_accum_rounds}, "
          f"d_reg {cfg.d_reg_accum_rounds}; live batch {live}; "
          f"r1_gamma {cfg.loss.r1_gamma:.6g}; ada_p {float(state.ada_p)}")
    seconds, peak_mem, launches_total = {}, {}, 0
    for i, name in enumerate(SCHEDULE):
        before = {k: clone_tree(getattr(state, k))
                  for k in ("g_params", "d_params", "g_ema")}
        nimg = state.cur_nimg
        fmc.fused_modconv3x3.launches = 0
        state, metrics = steps[name](state, real, None, z, None,
                                     key.fold_in(i))
        torch.cuda.synchronize()
        launches = fmc.fused_modconv3x3.launches
        launches_total += launches
        shown = {k: round(float(v), 5) for k, v in metrics.items()}
        print(f"{name}: fused_modconv3x3 launches {launches} (expected "
              f"{want}: 2 levels x {cfg.accum_rounds} main rounds); {shown}")
        if launches != want:
            raise AssertionError(f"{name}: {launches} launches, not {want}")
        bad = [k for k, v in metrics.items()
               if not bool(torch.isfinite(v).all())]
        if bad:
            raise AssertionError(f"{name}: non-finite metrics {bad}")
        if state.cur_nimg != nimg + TRAIN_BATCH:
            raise AssertionError(f"{name}: cur_nimg {state.cur_nimg}")
        for k, tree in before.items():
            moved = max_change(getattr(state, k), tree)
            if not moved > 0:
                raise AssertionError(f"{name}: {k} did not change")
        del before
        if name != "none" and not float(state.pl_mean) > 0:
            raise AssertionError(f"{name}: pl_mean {float(state.pl_mean)}")
        # The timed run of the same variant (allocator and cuDNN warm).
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = steps[name](state, real, None, z, None,
                                     key.fold_in(10 + i))
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        peak_mem[name] = torch.cuda.max_memory_allocated()
        print(f"{name}: {seconds[name]:.4f} s/step, peak memory "
              f"{peak_mem[name] / 2 ** 30:.3f} GiB, pl_mean "
              f"{float(state.pl_mean):.5g} on {card}", flush=True)
    new_p = ts.ada_update(cfg, state.ada_p,
                          float(metrics["Loss/signs/real"]))
    state.ada_p = torch.tensor(new_p, device=state.ada_p.device)
    print(f"ada_update: p {new_p:.6f} (signs/real "
          f"{float(metrics['Loss/signs/real']):.4f}, target {cfg.ada_target})")
    sec_per_batch = sum(SCHEDULE[k] * seconds[k] for k in SCHEDULE) / 16
    print(f"train FFHQ-1024 batch {TRAIN_BATCH}: "
          f"{sec_per_batch / TRAIN_BATCH * 1000:.4f} s/kimg "
          f"((12 none + 3 greg + 1 both) / 16 = {sec_per_batch:.4f} s/batch) "
          f"on {card}")

    augment_fn = augment.make_augment_fn(aug_cfg)
    real8, z8 = real[:live], z[:live]

    # One Dmain round with the GA splice.
    fmc.fused_modconv3x3.launches = 0
    _, m, grads = round_grads(lambda: gan_loss.d_main_loss(
        cfg.loss, g_cfg, d_cfg, state.g_params, state.d_params, real8, None,
        z8, None, key.fold_in(20), augment_fn, state.ada_p, ga_threshold=0.5,
        ga_mutation_rate=cfg.ga_mutation_rate), {"D": state.d_params})
    torch.cuda.synchronize()
    ga_launches = fmc.fused_modconv3x3.launches
    launches_total += ga_launches
    replaced = float(m["Loss/ga/replaced"])
    print(f"GA Dmain round (threshold 0.5, live batch {live}): "
          f"Loss/ga/replaced {replaced:.4f}, fused_modconv3x3 launches "
          f"{ga_launches} (expected {2 * want // cfg.accum_rounds}: the fakes' "
          f"G forward and the offspring's synthesis)")
    if not 0.0 <= replaced <= 1.0 or ga_launches != 2 * want // cfg.accum_rounds:
        raise AssertionError("GA round failed")
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        raise AssertionError("GA round: non-finite D gradients")
    del grads

    grads_check(g_cfg, d_cfg, cfg, state, real8, z8, key.fold_in(30),
                augment_fn)
    torch.backends.cudnn.allow_tf32 = True
    trace_train_step(steps["none"], state, inputs, key.fold_in(40))
    return launches_total, seconds, peak_mem, sec_per_batch


def grads_check(g_cfg, d_cfg, cfg, state, real, z, key, augment_fn):
    """One simultaneous main round at live batch 8 with pallas_level=True
    and False on the same state and draws, TF32 off.  The fused levels
    round at other places than the composed path (see main_phase), so the
    fakes differ by about 1% RMS and every gradient downstream of them by
    about as much; bounds: relative L2 over all G (all D) gradients
    <= 2^-4, and <= 2^-2 for each leaf of the two fused levels.  A wrong
    backward formula or layout errs by O(100%) there."""
    torch.backends.cudnn.allow_tf32 = False
    plain = dataclasses.replace(g_cfg, synthesis=dataclasses.replace(
        g_cfg.synthesis, pallas_level=False))
    grads = {}
    for label, gc in (("pallas", g_cfg), ("composed", plain)):
        _, _, grads[label] = round_grads(lambda: gan_loss.gd_main_loss(
            cfg.loss, gc, d_cfg, state.g_params, state.d_params, real, None,
            z, None, key, augment_fn, state.ada_p),
            {"G": state.g_params, "D": state.d_params})
    torch.cuda.synchronize()
    a, b = grads["pallas"], grads["composed"]
    g_keys = [k for k in a if k.startswith("G/")]
    d_keys = [k for k in a if k.startswith("D/")]
    level_keys = [k for k in g_keys
                  if ".b128.conv1." in k or ".b256.conv1." in k]
    g_err, d_err = rel_l2(a, b, g_keys), rel_l2(a, b, d_keys)
    level_err = {k: rel_l2(a, b, [k]) for k in level_keys}
    print(f"pallas vs composed gradients (TF32 off, live batch {len(z)}): "
          f"G rel_l2 {g_err:.4g}, D rel_l2 {d_err:.4g}")
    for k, v in level_err.items():
        print(f"  {k}: rel_l2 {v:.4g}")
    if not (g_err <= 2 ** -4 and d_err <= 2 ** -4
            and all(v <= 2 ** -2 for v in level_err.values())):
        raise AssertionError("pallas and composed gradients disagree")


def trace_train_step(step, state, inputs, key, top=12):
    """One torch.profiler trace of a "none" step: the kernels with the most
    device time, the fused level's forward launches (fold + conv) and its
    backward (the kernels under the fused_modconv3x3_bwd range) as shares
    of the device time of all kernels, copies and fills."""
    from torch.profiler import ProfilerActivity, profile

    real, _, z, _, _ = inputs
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, real, None, z, None, key)
        torch.cuda.synchronize()
    device_us, bwd_us = {}, 0.0
    for evt in prof.events():
        if evt.name == "fused_modconv3x3_bwd":
            if evt.device_type == torch.autograd.DeviceType.CPU:
                bwd_us += evt.device_time_total
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            device_us[evt.name] = (device_us.get(evt.name, 0.0)
                                   + evt.time_range.elapsed_us())
    total = sum(device_us.values())
    print(f"trace of one batch-{len(z)} 'none' train step (pallas_level=True):")
    if total <= 0:
        print("  device time: not measured (the trace holds no CUDA kernels)")
        return
    for name, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:9.4f} ms {100 * us / total:6.2f}%  {name[:110]}")
    fwd = sum(us for name, us in device_us.items()
              if "modconv_bf16_kernel" in name or "fold_taps_kernel" in name)
    print(f"  device time {total / 1e3:.4f} ms; fused level forward "
          f"{fwd / 1e3:.4f} ms ({100 * fwd / total:.2f}%), its backward "
          f"{bwd_us / 1e3:.4f} ms ({100 * bwd_us / total:.2f}%)")


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
        check_pngs(out, names, (1024, 1024, 3))
        print(f"cli: {names}, fused_modconv3x3 launches {launches}")
        if launches != 4:
            raise AssertionError(f"cli made {launches} kernel launches, not 4")
    return launches


def check_pngs(out, names, shape):
    """Each PNG reads back at ``shape`` with some spread of values."""
    for name in names:
        img = png.read_png(os.path.join(out, name))
        if img.shape != shape or img.std() == 0:
            raise AssertionError(f"{name}: {img.shape}, std {img.std()}")


class TimedLoader:
    """The loop's loader with the host time spent waiting in ``next``."""

    def __init__(self, inner):
        self.inner, self.wait_s, self.batches = inner, 0.0, 0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.inner)
        self.wait_s += time.perf_counter() - t0
        self.batches += 1
        return batch

    def close(self):
        self.inner.close()


def png_decode_rate(tmp, card):
    """ms to decode one 1024^2 RGB PNG with filter 0 and with Paeth on every
    row (utils/png.read_png, on this host's CPU)."""
    img = np.random.RandomState(1).randint(0, 256, (1024, 1024, 3)).astype(
        np.uint8)
    for ft, label in ((0, "filter 0"), (4, "Paeth")):
        path = os.path.join(tmp, f"decode{ft}.png")
        png.write_png(path, img, level=1, filter_type=ft)
        t0 = time.perf_counter()
        got = png.read_png(path)
        ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(got, img):
            raise AssertionError(f"read_png ({label}) changed the pixels")
        print(f"PNG decode, 1024x1024 RGB, {label}: {ms:.2f} ms "
              f"({3 * 2 ** 20 / ms / 1e3:.2f} MB/s) on the host of {card}")


def loop_phase(tmp, card, train_sec_per_kimg):
    """A training run through the command users start, at FFHQ-1024 on
    LOOP_IMAGES random PNGs, --kimg 1 at --batch 32: the loop's plan gives
    main rounds of 8 (fused level in G's forward, 2 levels a round), Greg
    rounds of 16 (pallas_level off) and R1 with a remat'd D.  Returns the
    run dir, the fused launches and the loop's own sec/kimg."""
    phase("loop")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    data, run_dir = os.path.join(tmp, "data"), os.path.join(tmp, "run")
    os.makedirs(data)
    rng = np.random.RandomState(0)
    for i in range(LOOP_IMAGES):
        png.write_png(os.path.join(data, f"{i:05d}.png"), rng.randint(
            0, 256, (LOOP_RES, LOOP_RES, 3)).astype(np.uint8), level=1)
    loaders = []
    orig_loader = loop_lib.data_loader

    def timed_loader(*a, **k):
        loaders.append(TimedLoader(orig_loader(*a, **k)))
        return loaders[-1]

    loop_lib.data_loader = timed_loader
    fmc.fused_modconv3x3.launches = 0
    t0 = time.perf_counter()
    try:
        state = train_cli.main([
            "--data", data, "--outdir", run_dir, "--gpus", "1", "--cfg",
            "auto", "--batch", str(LOOP_BATCH), "--kimg", str(LOOP_KIMG),
            "--aug", "ada",
            "--augpipe", "bgc", "--snap", "1", "--seed", "0", "--device",
            DEVICE])
        torch.cuda.synchronize()
    finally:
        loop_lib.data_loader = orig_loader
    wall = time.perf_counter() - t0
    launches = fmc.fused_modconv3x3.launches

    run = train_cli.build_run(LOOP_RES, batch=LOOP_BATCH, kimg=LOOP_KIMG)
    batches = state.cur_nimg // LOOP_BATCH
    if (state.cur_nimg < 1000 * LOOP_KIMG or batches != loaders[0].batches
            or state.cur_nimg != batches * LOOP_BATCH):
        raise AssertionError(f"loop ended at {state.cur_nimg} images after "
                             f"{loaders[0].batches} batches")
    rounds = run.train_cfg.accum_rounds
    live = LOOP_BATCH // rounds
    grid_n = run.loop_cfg.grid_size[0] * run.loop_cfg.grid_size[1]
    want = (expected_launches(run.g_cfg, live) * rounds * batches
            + expected_launches(run.g_cfg, grid_n))
    print(f"loop: {batches} batches, plan {json.dumps(run.plan())}, "
          f"reg_remat {run.reg_remat}; fused_modconv3x3 launches {launches} "
          f"(expected {want}: 2 levels x {rounds} main rounds x {batches} "
          f"batches + 2 for the grid)")
    if launches != want:
        raise AssertionError(f"loop: {launches} launches, not {want}")

    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    last = lines[-1]
    need = ("Loss/G/loss", "Loss/D/loss", "Loss/signs/real",
            "Progress/kimg", "Timing/sec_per_kimg", "Progress/augment")
    if len(lines) != 1 or any(not np.isfinite(last.get(k, np.nan))
                              for k in need):
        raise AssertionError(f"stats.jsonl: {len(lines)} lines, {last}")
    if (last["Progress/kimg"] != state.cur_nimg / 1e3
            or not 0.0 <= last["Progress/augment"] <= 1.0):
        raise AssertionError(f"stats.jsonl: {last}")
    kimg = state.cur_nimg // 1000
    gw, gh = run.loop_cfg.grid_size
    check_pngs(run_dir, [f"fakes{kimg:06d}.png"],
               (gh * LOOP_RES, gw * LOOP_RES, 3))
    snap = os.path.join(run_dir, f"network-snapshot-{kimg:06d}.npz")
    trees, config = ckpt.load_snapshot(snap)
    for name, tree in (("G", state.g_params), ("D", state.d_params),
                       ("G_ema", state.g_ema)):
        if set(ckpt.tree_to_flat(trees[name])) != set(ckpt.tree_to_flat(tree)):
            raise AssertionError(f"snapshot: {name} keys differ")
    if (config_lib.generator_config_from_dict(config["g_cfg"]) != run.g_cfg
            or config_lib.discriminator_config_from_dict(config["d_cfg"])
            != run.d_cfg):
        raise AssertionError("snapshot: configs differ from the run's")
    wait = loaders[0].wait_s
    sec_per_kimg = last["Timing/sec_per_kimg"]
    print(f"loop {LOOP_RES}^2 batch {LOOP_BATCH}, one tick of {batches} "
          f"batches: {sec_per_kimg:.4f} s/kimg (the loop's Timing/"
          f"sec_per_kimg; the train phase's schedule: "
          f"{train_sec_per_kimg:.4f} s/kimg); waited {wait:.4f} s on the "
          f"loader ({100 * wait / wall:.2f}% of the command's {wall:.2f} s); "
          f"the tick includes the first steps' warm-up; on {card}",
          flush=True)
    png_decode_rate(tmp, card)
    return snap, launches, sec_per_kimg


def remat_phase(card):
    """One simultaneous Gmain+Dmain round and one R1 round at FFHQ-1024,
    live batch 8, TF32 off, with G and D remat'd and not, on the same state
    (noise strengths and biases non-zero, so the layer noise counts) and
    the same draws.

    Gradients: each variant runs twice with PyTorch's deterministic
    algorithms asked for (``use_deterministic_algorithms``, warn only: an
    op without a deterministic version runs as before).  A remat'd block
    recomputes its forward with the same kernels on the same inputs (layer
    noise from the same Rng key), so its gradients can differ from the
    plain path's only as much as two runs of one variant differ: by the
    summation order of the atomics that remain.  The bound is four times
    the larger run-to-run difference plus 2^-14 (6e-5), relative L2 over
    all G (all D) gradients; a recomputation on other values (other noise,
    another block's input) errs by percents.  Then two runs of each
    variant with the default algorithms, in the order plain, remat, remat,
    plain, give its time and peak memory."""
    import warnings

    phase("remat")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, state, (real, _, z, _, key) = train_entry(DEVICE, batch=REMAT_BATCH,
                                                 ada_p=0.2)
    seeded_weights(state.g_params)
    g_cfg, d_cfg, cfg, aug_cfg = train_configs(REMAT_BATCH)
    augment_fn = augment.make_augment_fn(aug_cfg)
    variants = {"plain": (g_cfg, d_cfg)}
    variants["remat"] = (
        dataclasses.replace(g_cfg, synthesis=dataclasses.replace(
            g_cfg.synthesis, remat=True)),
        dataclasses.replace(d_cfg, remat=True))
    rounds = {
        "main": lambda g, d: round_grads(lambda: gan_loss.gd_main_loss(
            cfg.loss, g, d, state.g_params, state.d_params, real, None, z,
            None, key, augment_fn, state.ada_p),
            {"G": state.g_params, "D": state.d_params}),
        "r1": lambda g, d: round_grads(lambda: gan_loss.d_r1_loss(
            cfg.loss, d, state.d_params, real, None, key.fold_in(1),
            augment_fn, state.ada_p), {"D": state.d_params}),
    }
    live = REMAT_BATCH
    want_launches = {("main", "plain"): expected_launches(g_cfg, live),
                     ("main", "remat"): 2 * expected_launches(g_cfg, live),
                     ("r1", "plain"): 0, ("r1", "remat"): 0}
    total_launches = 0

    def run(rname, vname):
        nonlocal total_launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fmc.fused_modconv3x3.launches = 0
        t0 = time.perf_counter()
        _, _, grads = rounds[rname](*variants[vname])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fmc.fused_modconv3x3.launches
        total_launches += launches
        if launches != want_launches[rname, vname]:
            raise AssertionError(f"remat {rname} {vname}: {launches} "
                                 f"launches, not {want_launches[rname, vname]}")
        return grads, seconds, torch.cuda.max_memory_allocated()

    for rname in rounds:
        grads = {}
        cudnn_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for vname in variants:
                    for rep in range(2):
                        grads[vname, rep] = run(rname, vname)[0]
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = cudnn_det
        for group in ("G", "D"):
            keys = [k for k in grads["plain", 0] if k.startswith(group + "/")]
            if not keys:
                continue
            floor = max(rel_l2(grads[v, 1], grads[v, 0], keys)
                        for v in variants)
            err = rel_l2(grads["remat", 0], grads["plain", 0], keys)
            bound = 4 * floor + 2 ** -14
            print(f"remat {rname} round, {group} gradients (deterministic "
                  f"algorithms): remat vs plain rel_l2 {err:.4g}; "
                  f"run-to-run {floor:.4g}; bound {bound:.4g}")
            if not err <= bound:
                raise AssertionError(f"remat {rname}: {group} gradients "
                                     f"differ from the plain path's")
        del grads
        timed = {v: [] for v in variants}
        for vname in ("plain", "remat", "remat", "plain"):
            timed[vname].append(run(rname, vname)[1:])
        for vname, runs in timed.items():
            secs = [t for t, _ in runs]
            mem = max(m for _, m in runs)
            print(f"remat {rname} round, {vname}: {np.mean(secs):.4f} s "
                  f"(runs {', '.join(f'{t:.4f}' for t in secs)}), peak "
                  f"memory {mem / 2 ** 30:.3f} GiB, fused launches "
                  f"{want_launches[rname, vname]} (live batch {live}, TF32 "
                  f"off, default algorithms) on {card}", flush=True)
    return total_launches


def cli_snapshot_phase(snap):
    """generate --projected-w and style_mixing on the loop's snapshot."""
    phase("cli (loop snapshot)")
    tmp = os.path.dirname(snap)
    trees, config = ckpt.load_snapshot(snap, device=DEVICE)
    g_cfg = config_lib.generator_config_from_dict(config["g_cfg"])
    z = torch.randn((2, g_cfg.z_dim), generator=torch.Generator().manual_seed(
        4)).to(DEVICE)
    with torch.no_grad():
        ws = sg2.mapping_apply(g_cfg.mapping, trees["G_ema"]["mapping"], z)
    wpath = os.path.join(tmp, "w.npz")
    np.savez(wpath, w=ws.cpu().numpy())
    res = g_cfg.img_resolution
    one = expected_launches(g_cfg, 1)
    styles = f"0-{min(6, g_cfg.num_ws - 1)}"          # 0-6 at 1024^2
    total = 0
    # generate: one forward a w; style mixing: the 3 seeds in one batch,
    # then one forward per (row, col) pair.
    for label, fn, args, names, want in (
            ("generate --projected-w", generate.main,
             ["--projected-w", wpath], ["proj00.png", "proj01.png"], 2 * one),
            ("style_mixing --rows 0,1 --cols 2 --styles " + styles,
             style_mixing.main,
             ["--rows", "0,1", "--cols", "2", "--styles", styles],
             ["0-0.png", "0-2.png", "1-1.png", "1-2.png", "2-2.png",
              "grid.png"], expected_launches(g_cfg, 3) + 2 * one)):
        out = os.path.join(tmp, label.split()[0])
        fmc.fused_modconv3x3.launches = 0
        fn(["--network", snap, "--outdir", out, "--device", DEVICE] + args)
        torch.cuda.synchronize()
        launches = fmc.fused_modconv3x3.launches
        total += launches
        if sorted(os.listdir(out)) != sorted(names):
            raise AssertionError(f"{label} wrote {sorted(os.listdir(out))}")
        check_pngs(out, [n for n in names if n != "grid.png"],
                   (res, res, 3))
        if "grid.png" in names:
            check_pngs(out, ["grid.png"], (3 * res, 2 * res, 3))
        print(f"{label}: {sorted(names)}, fused_modconv3x3 launches "
              f"{launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"{label}: {launches} launches, not {want}")
    return total


def leaves_of(trees):
    return [t for tree in trees
            for t in ckpt.tree_to_flat_tensors(tree).values()]


def adapt_g_config():
    """The adapt phase's generator: FFHQ-1024 as entry_config() (8 mapping
    layers, pallas_level=True)."""
    return entry_config()


def adapt_phase(card):
    """One-shot CLIP adaptation through the command users run, then the
    checks and times of the module list above.  The CLI run and the timed
    steps use PyTorch's default math (TF32 convolutions on, TF32 matmuls
    off); the gradient check runs with TF32 off."""
    phase("adapt")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    g_cfg = adapt_g_config()
    params = seeded_weights(sg2.init_generator(
        g_cfg, torch.Generator().manual_seed(0), DEVICE))
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "ffhq1024.npz")
        ckpt.save_snapshot(snap, g_ema=params,
                           config={"g_cfg": config_lib.to_dict(g_cfg)})
        launches, npz = adapt_cli_run(tmp, snap, g_cfg, card)
        launches += s_direction_run(tmp, snap, npz, g_cfg, card)
    torch.cuda.empty_cache()
    adapt_grads_check(params, card)
    torch.cuda.empty_cache()
    rate = adapt_timing(params, card)
    return launches, rate


def adapt_cli_run(tmp, snap, g_cfg, card):
    """cli/adapt.py on ADAPT_CONFIG with the snapshot; returns the fused
    launches and the step-ADAPT_BACKUP checkpoint."""
    out = os.path.join(tmp, "adapt")
    overrides = [f"training.iter_num={ADAPT_ITERS}",
                 f"checkpointing.step_backup={ADAPT_BACKUP}",
                 f"logging.log_every={ADAPT_LOG}"]
    if ADAPT_CLIP_OVERRIDES:
        overrides.append(
            f"training.clip_config_overrides={ADAPT_CLIP_OVERRIDES!r}")
    needs = []
    bwd = fmc.fused_modconv3x3_bwd

    def recording_bwd(*args, **kw):
        needs.append(tuple(kw["needs"]))
        return bwd(*args, **kw)

    fmc.fused_modconv3x3_bwd = recording_bwd
    fmc.fused_modconv3x3.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = adapt_cli.main(
            ["--config", os.path.join(REPO, ADAPT_CONFIG), "--network", snap,
             "--outdir", out, "--device", DEVICE] + overrides)
        torch.cuda.synchronize()
    finally:
        fmc.fused_modconv3x3_bwd = bwd
    wall = time.perf_counter() - t0
    launches = fmc.fused_modconv3x3.launches
    batch = trainer.cfg.batch_size
    want = expected_launches(g_cfg, 2 * batch) * ADAPT_ITERS
    print(f"adapt cli: {ADAPT_ITERS} steps of td_single / s_delta at batch "
          f"{batch} (joint pass {2 * batch}) in {wall:.2f} s with the build "
          f"of the towers and the text embeddings; fused_modconv3x3 "
          f"launches {launches} (expected {want}: 2 levels x "
          f"{ADAPT_ITERS} joint passes), on {card}", flush=True)
    if launches != want:
        raise AssertionError(f"adapt: {launches} launches, not {want}")
    # The level's backward: dx and d(styles) (the offsets' gradient), never
    # the weight gradient of the frozen generator.
    if len(needs) != want or any(n[1] or not (n[0] and n[2]) for n in needs):
        raise AssertionError(f"adapt: the fused level's backward was asked "
                             f"for {sorted(set(needs))} in {len(needs)} calls")
    print(f"adapt: fused backward needs (dx, dW, dstyles, ddcoefs, dnoise, "
          f"dbias) = {sorted(set(needs))} in {len(needs)} calls: no dW")
    frozen = leaves_of([trainer.g_params] + [p for _, p in
                                             trainer.clip_encoders.values()])
    if any(t.requires_grad or t.grad is not None for t in frozen):
        raise AssertionError("adapt: a frozen G or CLIP tensor holds a grad")
    print(f"adapt: {len(frozen)} frozen G and CLIP tensors, none requires "
          f"grad or holds .grad")

    with open(os.path.join(out, "losses.jsonl")) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    steps = list(range(0, ADAPT_ITERS, ADAPT_LOG))
    if ([ln["step"] for ln in lines] != steps or not all(
            np.isfinite(v) for ln in lines for k, v in ln.items())):
        raise AssertionError(f"adapt: losses.jsonl {lines}")
    print("adapt losses.jsonl: " + "; ".join(
        f"step {ln['step']} total {ln['total']:.6f}" for ln in lines)
        + f", on {card}")
    npz = os.path.join(out, f"adaptation-{ADAPT_BACKUP:06d}.npz")
    meta, offsets, _ = ckpt.load_adaptation(npz)
    moved = max(float(t.abs().max()) for t in leaves_of([offsets]))
    if (meta["parametrization"] != "s_delta"
            or sorted(offsets) != sorted(g_cfg.synthesis.layer_names())
            or not moved > 0):
        raise AssertionError(f"adapt: {npz} holds {meta} / {moved}")
    if not os.path.exists(os.path.join(out, "config.yaml")):
        raise AssertionError("adapt: no config.yaml")
    print(f"adapt: {os.path.basename(npz)} loads, {len(offsets)} layers, "
          f"max|offset| {moved:.6f}, on {card}")
    return launches, npz


def s_direction_run(tmp, snap, npz, g_cfg, card):
    """generate for two seeds plain, with --s-direction at --s-scale 0 and
    with the trained direction: the first two byte-equal, the third not."""
    outs = {}
    launches = 0
    for label, extra in (("plain", []),
                         ("scale0", ["--s-direction", npz, "--s-scale", "0"]),
                         ("trained", ["--s-direction", npz])):
        outs[label] = os.path.join(tmp, "gen_" + label)
        fmc.fused_modconv3x3.launches = 0
        generate.main(["--network", snap, "--seeds", "0,1", "--outdir",
                       outs[label], "--device", DEVICE] + extra)
        torch.cuda.synchronize()
        launches += fmc.fused_modconv3x3.launches
    names = ["seed0000.png", "seed0001.png"]
    res = g_cfg.img_resolution
    for label in outs:
        check_pngs(outs[label], names, (res, res, 3))

    def data(label, name):
        with open(os.path.join(outs[label], name), "rb") as f:
            return f.read()

    same = [data("plain", n) == data("scale0", n) for n in names]
    differ = [data("plain", n) != data("trained", n) for n in names]
    want = 3 * 2 * expected_launches(g_cfg, 1)
    print(f"generate --s-direction: --s-scale 0 byte-equal to plain {same}, "
          f"trained direction differs {differ}; fused_modconv3x3 launches "
          f"{launches} (expected {want}), on {card}")
    if not (all(same) and all(differ)) or launches != want:
        raise AssertionError("generate --s-direction failed")
    return launches


def adapt_grads_check(params, card):
    """The offsets' gradient of one td_single step (CLIP in fp32, TF32 off)
    with pallas_level on and off, on the same offsets (0.2 * N(0, 1), so
    that the trainable half differs from the frozen one) and the same
    draws.  The fused level rounds at other places than the composed path
    (main_phase: about 1% RMS of the image); the loss reads the CLIP edit
    between the two halves, whose cancellation multiplies a relative error
    by |embedding| / |edit| (a few at this offset size); so a few percent
    is expected.  Bound: relative L2 over all offsets' gradients <= 2^-3.
    A wrong backward formula or layout errs by O(100%)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grads, losses = {}, {}
    for label, pallas in (("pallas", True), ("composed", False)):
        trainer = adapt_entry(DEVICE, batch=ADAPT_BATCH, pallas_level=pallas,
                              clip_dtype="float32", g_params=params)
        gen = torch.Generator().manual_seed(5)
        for t in leaves_of([trainer.offsets]):
            t.copy_(0.2 * torch.randn(t.shape, generator=gen))
        fmc.fused_modconv3x3.launches = 0
        losses[label], grads[label] = trainer.loss_and_grads(
            trainer.rng.fold_in(77))
        torch.cuda.synchronize()
        print(f"adapt gradient check, {label}: direction loss "
              f"{float(losses[label]['total']):.6f}, fused launches "
              f"{fmc.fused_modconv3x3.launches}, on {card}")
        del trainer
    a, b = grads["pallas"], grads["composed"]
    err = rel_l2(a, b, list(a))
    level = {k: rel_l2(a, b, [k]) for k in a
             if k.startswith(("b128.conv1", "b256.conv1"))}
    print(f"pallas vs composed offset gradients (TF32 off, CLIP fp32, batch "
          f"{ADAPT_BATCH}): rel_l2 {err:.4g} (bound {2 ** -3:.4g}); "
          + ", ".join(f"{k} {v:.4g}" for k, v in level.items())
          + f", on {card}")
    if not err <= 2 ** -3:
        raise AssertionError("adapt: pallas and composed offset gradients "
                             "disagree")


def adapt_timing(params, card):
    """bench.py's adaptation shape (td_single, s_delta, direction loss only,
    ViT-B/32 + ViT-B/16, batch 4) with PyTorch's default math: one synced
    step, then ADAPT_BLOCKS blocks of 10 steps, each ending in the one host
    read of its losses; the peak memory of those steps; one profiler trace
    of a step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    trainer = adapt_entry(DEVICE, batch=ADAPT_BATCH,
                          visual_encoders=("ViT-B/32", "ViT-B/16"),
                          loss_funcs=("direction",), loss_coefs=(1.0,),
                          g_params=params)
    trainer.train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(ADAPT_BLOCKS):
        t0 = time.perf_counter()
        for _ in range(10):
            losses = trainer.train_step_async()
        host = {k: float(v) for k, v in losses.items()}
        rates.append(10 / (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(v) for v in host.values()):
        raise AssertionError(f"adapt timing: losses {host}")
    rate = float(np.mean(rates))
    res = trainer.g_cfg.img_resolution
    print(f"adapt td_single {res}^2 batch {ADAPT_BATCH}, ViT-B/32 + "
          f"ViT-B/16, direction: {rate:.4f} steps/s (blocks of 10: "
          f"{', '.join(f'{r:.4f}' for r in rates)}), peak memory "
          f"{peak / 2 ** 30:.3f} GiB, on {card}", flush=True)
    trace_adapt_step(trainer, card, 1e3 / rate)
    return rate


def trace_adapt_step(trainer, card, step_ms, top=12):
    """One torch.profiler trace of a step: the kernels with the most device
    time, the fused level's forward (fold + conv) and backward shares, the
    share of the step's wall time (the "adapt_step" range, which ends in a
    synchronize) with no kernel, copy or fill running on the card, and that
    share of the unprofiled step (``step_ms``, from the timed blocks)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("adapt_step"):
            trainer.train_step_async()
            torch.cuda.synchronize()
    device_us, spans, bwd_us, wall_us = {}, [], 0.0, 0.0
    launch_us, launches, syncs = 0.0, 0, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if evt.name in ("adapt_step", "fused_modconv3x3_bwd"):
                continue
            device_us[evt.name] = (device_us.get(evt.name, 0.0)
                                   + evt.time_range.elapsed_us())
            spans.append((evt.time_range.start, evt.time_range.end))
        elif evt.name == "adapt_step":
            wall_us = evt.time_range.elapsed_us()
        elif evt.name == "fused_modconv3x3_bwd":
            bwd_us += evt.device_time_total
        elif evt.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx"):
            launch_us += evt.time_range.elapsed_us()
            launches += 1
        elif evt.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaMemcpyAsync", "cudaMemcpy"):
            n, us = syncs.get(evt.name, (0, 0.0))
            syncs[evt.name] = (n + 1, us + evt.time_range.elapsed_us())
    total = sum(device_us.values())
    print(f"trace of one adapt step (batch {trainer.cfg.batch_size}, "
          f"pallas_level=True) on {card}:")
    if total <= 0 or wall_us <= 0:
        print("  device time: not measured (the trace holds no CUDA kernels)")
        return
    busy, end = 0.0, -np.inf
    for start, stop in sorted(spans):          # union of the device spans
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    for name, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:9.4f} ms {100 * us / total:6.2f}%  {name[:110]}")
    fwd = sum(us for name, us in device_us.items()
              if "modconv_bf16_kernel" in name or "fold_taps_kernel" in name)
    print(f"  step wall {wall_us / 1e3:.4f} ms, device busy {busy / 1e3:.4f} "
          f"ms: {100 * (1 - busy / wall_us):.2f}% of the step with no kernel "
          f"on the card; kernel time {total / 1e3:.4f} ms, fused level "
          f"forward {fwd / 1e3:.4f} ms ({100 * fwd / total:.2f}%), its "
          f"backward {bwd_us / 1e3:.4f} ms ({100 * bwd_us / total:.2f}%)")
    print(f"  unprofiled step {step_ms:.4f} ms (timed blocks): "
          f"{100 * max(0.0, 1 - busy / 1e3 / step_ms):.2f}% of it with no "
          f"kernel on the card, at this trace's device busy time")
    print(f"  host: {launches} kernel launches, {launch_us / 1e3:.4f} ms in "
          f"the launch calls ({len(spans)} kernels, copies and fills on the "
          f"card); the profiler's own cost is in the step's wall time")
    print("  host waits and copies: " + (", ".join(
        f"{name} x{n} {us / 1e3:.4f} ms" for name, (n, us) in sorted(
            syncs.items())) or "none"))


def main():
    card, peaks = device_phase()
    build_phase()
    k = kernel_phase(peaks)
    params, launches = main_phase(card)
    cli_launches = cli_phase(params)
    del params
    torch.cuda.empty_cache()
    train_launches, seconds, peak_mem, sec_per_batch = train_phase(card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        snap, loop_launches, loop_sec_per_kimg = loop_phase(
            tmp, card, sec_per_batch / TRAIN_BATCH * 1000)
        torch.cuda.empty_cache()
        remat_launches = remat_phase(card)
        torch.cuda.empty_cache()
        cli_launches += cli_snapshot_phase(snap)
    torch.cuda.empty_cache()
    adapt_launches, adapt_rate = adapt_phase(card)
    by_path = {"forward": launches, "cli": cli_launches,
               "train": train_launches, "loop": loop_launches,
               "remat": remat_launches, "adapt": adapt_launches}
    kernels = [dict(
        name="fused_modconv3x3", route="cuda",
        source="gagan_tpu_torch/csrc/fused_modconv.cu",
        replaces="gagan_tpu/ops/pallas_modconv.py:76",
        launches=sum(by_path.values()), launches_by_path=by_path,
        max_abs_err=k["max_abs_err"], ms=k["ms"],
        fold_ms=k["fold_ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by="operations" if k["flop_ms"] >= k["byte_ms"] else "bytes",
        library_ms=k["library_ms"], bwd_ms=k["bwd_ms"],
        fwd_bwd_ms=k["fwd_bwd_ms"], bwd_plain_ms=k["bwd_plain_ms"],
        bwd_bound_ms=k["bwd_bound_ms"], bwd_max_rel_err=k["bwd_max_rel_err"],
        bwd_max_rel_l2_err=k["bwd_max_rel_l2_err"])]
    print(f"(kernel times: the launches of one batch-{BATCH} forward, "
          f"b128.conv1 + b256.conv1, on {card}; bwd_*: the level's composed "
          f"backward at the same shapes; train: s/step "
          f"{ {n: round(v, 4) for n, v in seconds.items()} }, peak GiB "
          f"{ {n: round(v / 2 ** 30, 3) for n, v in peak_mem.items()} }, "
          f"{sec_per_batch / TRAIN_BATCH * 1000:.4f} s/kimg; loop: "
          f"{loop_sec_per_kimg:.4f} s/kimg; adapt: {adapt_rate:.4f} "
          f"steps/s)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
