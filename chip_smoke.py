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
               (KERNEL_CASES: the main path's shapes in bf16 and in fp32
               (PPL's force_fp32 route), and edge cases in both, TF32 off),
               its fold launch bit-equal to the plain fold, timed beside
               its bound, its fold launch alone, the plain version and one
               cuDNN call; at the main path's two bf16 levels also
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
               one main round (TF32 off), one torch.profiler trace of a step
               (the ADA pipe takes the native-resolution "fast" warp, as the
               JAX command's jitted step does);
     warp    - the ADA pipe (bgc bf16, batch 32, 1024^2, p = 1) with the
               "fast" and the "exact" geometry: forward and forward+backward
               ms and peak memory; "fast" on the card against the CPU;
     dataset - 32 seeded 1024^2 PNGs through data/dataset_tool.py into a
               zip (Pillow's per-row filters: Paeth rows), read back by
               NativeZipDataset (the C++ loader built with g++ and zlib) and
               ImageFolderDataset: equal pixels, labels and order, the time
               of a batch of 32 each;
  7. loop    - a training run as users start it, at FFHQ-1024 on that zip
               (gagan_tpu_torch.cli.train, --cfg auto --batch 32 --kimg 1:
               32 batches, R1 with a remat'd D): the loader it took,
               stats.jsonl, the image grid, the network snapshot, the fused
               launches, the loop's own sec/kimg and its wait on the loader;
               the PNG decode rate (filter 0 and Paeth) on this host;
  8. remat   - one Gmain+Dmain round and one R1 round at live batch 8 (TF32
               off) with G and D remat'd and not: gradients against each
               other, times, peak memory, fused launches;
  9. cli     - on the loop's snapshot: generate --projected-w and
               style_mixing, their PNGs and launch counts;
 10. fewshot - few-shot Affine+ adaptation as bench.py::bench_adapt10
               shapes it: the loop's snapshot saved as NVlabs-layout state
               dicts and converted by cli/convert_weights.py (bit-equal, no
               resample filters); cli/train.py --use-domain-modulation
               (out_in_additive, G's affines and the b64 weight offsets,
               glrate 0.02) resumed from it for 4 batches: the files, the
               b64 offsets moved, G's frozen leaves bit-equal, its affines
               and D moved, the fused level's backward asked for no dW,
               generate --s-direction with the offsets; the three variants
               of entry.fewshot_entry checked and timed (s/step, scheduled
               s/kimg, peak memory); pallas vs composed gradients of the
               affines and offsets (TF32 off); one adaptive layer probe at
               FFHQ-1024 (train/auto_layers.py, random ViT-B/32);
 11. adapt   - one-shot CLIP adaptation (StyleGAN-NADA td_single, s_delta
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
 12. im2im   - one-shot image-to-image adaptation at FFHQ-1024 with random
               towers of the real shape (ViT-B/32 + ViT-B/16, VGG16, e4e
               IR-SE-50 with 18 style heads): cli/projector.py on a 1024^2
               PNG rendered by G (20 steps in w space, --save-image: the
               latents, the PNGs, the LPIPS distance at steps 1 and 20, s/step
               and peak memory, 2 fused launches a step whose backward is
               asked for d(noise) and never dW); cli/adapt.py on
               im2im_difa.yaml, im2im_jojo.yaml and im2im_mtg.yaml with that
               style PNG, projected for 10 steps, 11 steps each (the files,
               moved offsets, G bit-equal to the snapshot, finite losses,
               difa_psp_loss in the DiFa run, the fused launches, no dW);
               steps/s of bench.py's DiFa step (batch 4, s_delta,
               direction + difa_local + SCC 6.0) in blocks of 10, its peak
               memory and a trace (top kernels, fused share, the forward
               shares of e4e and of its backbone, idle share, host launches
               and syncs); pallas vs composed gradients of a DiFa step and
               of a projector step, whose noise gradients are held against
               an fp32 G (TF32 off);
 13. ga      - the GA StyleSpace direction search (entry.ga_entry: 32
               candidates of 4 images at FFHQ-1024, elite 4, a random Swin-T
               fitness on the raw 1024^2 images) for 2 generations in scan
               and batched mode from one key: history and best agree, fused
               launches (192 scan, 6 batched), no backward, candidates/s and
               peak memory per mode; pallas vs composed images and scores of
               a batched generation; a trace of one (G's and Swin-T's
               shares, idle share); calculate_metrics (Swin-T FID / KID,
               alex-LPIPS) of the best direction against the loop's PNGs;
     dist    - (after ga) data parallelism over torch.distributed ranks
               (parallel/mesh.py), deterministic algorithms, TF32 off: an
               NCCL world of one takes the three variants at FFHQ-1024,
               batch 32, bit-equal to the step without a process group (and
               its s/step beside it); then two ranks share the card over
               gloo (NCCL refuses that): "none" at global batch 32 in the
               two-device plan (rounds of 8 a rank) for fused launches,
               s/step, the gradient all_reduce alone and peak memory per
               rank; the three variants in fp32 at global batch 8 against
               the one-process step of that plan (gradients, losses,
               pl_mean, w_avg, ada_p, each within its bound; the ranks
               bit-equal), and two planted faults that the bounds must
               fail (mbstd over a rank's rows, every rank drawing the
               first rows); the
               training loop on the dataset zip for 4 batches (files from
               rank 0 only, one snapshot, stats.jsonl against the
               one-process loop, each rank's loader and wait); the GA with
               ``mesh=`` against the ga phase's batched run (scores,
               history, best) and its candidates/s; parallel/dryrun.py's
               resume cycle at batch 8, bit-equal;
     spatial - (after dist) spatial (height) sharding over two gloo ranks
               sharing the card (parallel/spatial.py), deterministic
               algorithms, TF32 off (SpatialPlan): (a) spatial_synthesis_fn
               at FFHQ-1024, batch 4, fp32, min_res 256 and 64, gathered,
               against the one-process forward (SPATIAL_BOUNDS; zero-filled
               halos must fail it), the bf16 difference, fused launches a
               rank; (b) the three variants in fp32 at global batch 4 with
               the ADA pipe and the GA Dmain round against the one-process
               step of the same plan (each quantity within its bound, the
               ranks bit-equal) and two planted faults that must fail them
               (zero-filled halos, gradients divided by the world size);
               (c) a bf16 "none" step at global batch 8 in four arms (one
               process, two-rank data parallelism, spatial at min_res 256
               and 128): s/step, peak memory a rank (each spatial arm's
               below the one process's), all_reduces and bytes a step;
               (d) training_loop with spatial_shard_min_res 256 for 2
               batches: files from rank 0 only, the stats line, the replica
               check before the snapshot;
 14. metrics - cli/calc_metrics.py --metrics fid1k,kid1k on the loop's
               snapshot and PNGs, twice (metric-*.jsonl, the random-detector
               warning, the second run's dataset statistics read from the
               cache and bit-equal); the compute functions of pr50k3, is50k
               and ppl2_wend at 256 samples (PPL's fused launches in fp32);
               ppl2_wend's per-sample distances pallas vs composed (fp32,
               TF32 off, 64 samples); Inception features pallas vs
               composed; the generator-stats rate (G + resize +
               Inception) and its peak memory;
 15. inversion - image -> W+ -> edits -> (source, adapted) pairs at FFHQ-1024
               on a 1024^2 PNG rendered by G: inference.project_restyle for
               each of the six ReStyle encoder types (random towers of the
               real shape, 5 iterations at batch 1: every iteration finite,
               12 fused launches, no backward); run_on_batch timed at batch 4
               (images/s, peak memory) and held against the composed level
               per iteration (TF32 off); convert_weights restyle on a seeded
               reference-layout checkpoint (bit-equal leaves, then
               project_restyle on the npz: fp32 G, no launch); the
               Inferencer's zero / seeded s_delta and ``original``
               adaptations on the ReStyle W+; II2S (20 of 1300 steps, a PCA
               of 100,000 samples, random VGG16-LPIPS: s/step, peak memory,
               the PCA's card and host times, 2 fused launches a step whose
               backward is asked for dx, d(styles), d(dcoefs) only; pallas
               vs composed W+ gradient); InterFaceGAN, StyleSpace (on the
               fused levels, with a direction, both ways) and StyleFlow
               (real config, dopri5 and rk4: steps, host reads, round trip)
               edits; e4e's latent D through a pool of 50 (losses, R1, 3 Adam
               steps);
 16. face    - a seeded 1024^2 photo through the MTCNN cascade (seeded
               random nets) on the card and on the CPU (counts by stage,
               boxes and landmarks), align_face_auto to 1024^2 (4096^2 quad
               map and Lanczos on the card) against the host route,
               MTCNN.align to 112^2, and inference.project_e4e of the
               aligned face (2 fused launches) against the composed level;
               the time of each step;
     state   - (after train) save_train_state / load_train_state of the
               train phase's state (G, D, G_ema, both Adam states, ADA):
               every leaf bit-equal, the bytes on disk, the save and load
               seconds; one step from the restored state against two from
               the original (deterministic algorithms);
     tail    - (after state) the FFHQ-1024 forward with packed_tail_blocks
               1, 2 and 3, with the fused torgb and without, and an "orig"
               G, each against the unpacked composed forward, with its
               fused launches and ms at batch 32; a "none" train step with
               packed_tail_blocks 2;
     examples - (after face) the five examples at FFHQ-1024 on a seeded
               snapshot and two adaptation checkpoints: PNGs, fused
               launches, wall time, against the pallas_level=False run;
     zoo     - make_generator of stylegan2, proggan, sn_anime, sn_mnist and
               biggan (BigGAN-PyTorch's 128^2 widths) at batch 8: forward,
               gen_shifted, images/s, the card against the CPU at batch 1;
 17. a JSON line of the kernels, then the JSON ok line.
Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from gagan_tpu_torch import _build, editing, inference  # noqa: E402
from gagan_tpu_torch.cli import adapt as adapt_cli  # noqa: E402
from gagan_tpu_torch.cli import generate, style_mixing  # noqa: E402
from gagan_tpu_torch.cli import projector as projector_cli  # noqa: E402
from gagan_tpu_torch.cli import train as train_cli  # noqa: E402
from gagan_tpu_torch.data import ImageFolderDataset  # noqa: E402
from gagan_tpu_torch.data import dataset_tool  # noqa: E402
from gagan_tpu_torch.data import native_loader  # noqa: E402
from gagan_tpu_torch.face import align as face_align  # noqa: E402
from gagan_tpu_torch.face import mtcnn as face_mtcnn_lib  # noqa: E402
from gagan_tpu_torch.inversion import encoders as enc_lib  # noqa: E402
from gagan_tpu_torch.cli import calc_metrics as calc_metrics_cli  # noqa: E402
from gagan_tpu_torch.cli import convert_weights  # noqa: E402
from gagan_tpu_torch.data.dataset import read_rgb  # noqa: E402
from gagan_tpu_torch.editing import styleflow  # noqa: E402
from gagan_tpu_torch.entry import (FEWSHOT_OPTIONS,  # noqa: E402
                                   ZOO_MODELS, adapt_entry, dp_train_entry,
                                   entry, entry_config, examples_config,
                                   examples_entry, fewshot_entry, ga_entry,
                                   im2im_entry, rescale_random_convs,
                                   restyle_entry, spatial_train_entry,
                                   train_configs, train_entry, train_run,
                                   zoo_entry)
from gagan_tpu_torch.examples import numpy_latents  # noqa: E402
from gagan_tpu_torch.ga import evaluation as ga_eval  # noqa: E402
from gagan_tpu_torch.ga import search as ga_search  # noqa: E402
from gagan_tpu_torch.inversion import e4e_training, ii2s  # noqa: E402
from gagan_tpu_torch.inversion import projector  # noqa: E402
from gagan_tpu_torch.inversion import restyle as restyle_lib  # noqa: E402
from gagan_tpu_torch.metrics import detectors  # noqa: E402
from gagan_tpu_torch.metrics import feature_stats as fs  # noqa: E402
from gagan_tpu_torch.metrics import inception_score as is_lib  # noqa: E402
from gagan_tpu_torch.metrics import ppl as ppl_lib  # noqa: E402
from gagan_tpu_torch.metrics import precision_recall as pr_lib  # noqa: E402
from gagan_tpu_torch.models import stylegan2 as sg2  # noqa: E402
from gagan_tpu_torch.ops import fused_modconv as fmc  # noqa: E402
from gagan_tpu_torch.parallel import dryrun  # noqa: E402
from gagan_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from gagan_tpu_torch.parallel import spatial as spatial_lib  # noqa: E402
from gagan_tpu_torch.params import offsets as offs_lib  # noqa: E402
from gagan_tpu_torch.train import augment, gan_loss  # noqa: E402
from gagan_tpu_torch.train import auto_layers  # noqa: E402
from gagan_tpu_torch.train import loop as loop_lib  # noqa: E402
from gagan_tpu_torch.train import masks as masks_lib  # noqa: E402
from gagan_tpu_torch.train import train_step as ts  # noqa: E402
from gagan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from gagan_tpu_torch.utils import config as config_lib  # noqa: E402
from gagan_tpu_torch.utils import png  # noqa: E402
from gagan_tpu_torch.ops.resize import resize_uint8  # noqa: E402
from gagan_tpu_torch.utils.rng import Rng  # noqa: E402

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
# The loop's figure before the fast warp (the loop phase's Timing/
# sec_per_kimg over PRs 4-10, H100 80GB HBM3, 700 W; PERF.md section 5).
LOOP_SEC_PER_KIMG_BEFORE = "72.39-100.79"
# The warp phase: the ADA pipe at the train phase's batch and 1024^2 (padded
# to 1536^2 by the fast branch), WARP_ITERS timed calls a mode; the card
# against the CPU on WARP_CHECK_BATCH images of WARP_CHECK_RES^2.
WARP_RES, WARP_ITERS, WARP_CHECK_BATCH, WARP_CHECK_RES = 1024, 3, 4, 64
# The face phase: a seeded 1024^2 photo, MTCNN random weights from this
# generator seed (regression heads scaled, see face_mtcnn) and thresholds
# that keep a few to a few hundred boxes at each stage (the reference's
# defaults, which align_face_auto and MTCNN.align use; tuned on the CPU
# route, which runs the same arithmetic).
FACE_RES, FACE_TRANSFORM, FACE_MTCNN_SEED = 1024, 4096, 0
FACE_THRESHOLDS = (0.15, 0.25, 0.35)
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
# The fewshot phase: cli/train.py with bench.py::bench_adapt10's options
# (Affine+ out_in_additive, G's affines and the weight offsets of block
# b<FEWSHOT_BLOCK>, glrate 0.02) for FEWSHOT_KIMG (4 batches of 32: one
# "both", three "none"), resumed from the loop's snapshot converted from
# NVlabs-layout state dicts; then the adaptive layer probe at FFHQ-1024.
FEWSHOT_BLOCK, FEWSHOT_KIMG = 64, 0.128
PROBE_BATCH, PROBE_ITERS, PROBE_K = 2, 2, 10
# The im2im phase: cli/projector.py for PROJECT_STEPS steps on a 1024^2 PNG
# rendered by G; cli/adapt.py on each of IM2IM_CONFIGS with that PNG as the
# style image, projected for IM2IM_INVERSION steps, for IM2IM_ITERS steps
# (losses every IM2IM_LOG, the checkpoint at the last); the DiFa step of
# bench.py at batch IM2IM_BATCH timed in IM2IM_BLOCKS blocks of 10 steps.
PROJECT_STEPS = 20
IM2IM_CONFIGS = ("im2im_difa", "im2im_jojo", "im2im_mtg")
IM2IM_ITERS, IM2IM_LOG, IM2IM_INVERSION = 11, 10, 10
IM2IM_BATCH, IM2IM_BLOCKS = 4, 3
# The ga phase: evolve_directions of entry.ga_entry (32 candidates of 4
# images, elite 4, Swin-T fitness) for GA_GENERATIONS generations from
# Rng(GA_SEED), in both evaluation modes; calculate_metrics on the loop's
# PNGs against GA_EVAL_IMAGES renders of the best direction.
GA_GENERATIONS, GA_SEED, GA_EVAL_IMAGES = 2, 3, 32
# The metrics phase: cli/calc_metrics.py on the loop's snapshot and PNGs for
# METRICS (twice: the second run reads the cached dataset statistics) at
# --batch METRICS_BATCH; then the compute functions of pr50k3, is50k and
# ppl2_wend at METRICS_SAMPLES generated samples.
METRICS, METRICS_BATCH, METRICS_SAMPLES = ("fid1k", "kid1k"), 32, 256
# ppl2_wend's per-sample distances, kernel against composed fp32 path, at
# this many samples.
PPL_CHECK_SAMPLES = 64
# The state phase saves the train phase's state as this step.  The tail
# phase runs the FFHQ-1024 forward with these packed_tail_blocks, and one
# train step with TAIL_TRAIN.  The examples run at EXAMPLES_RES^2; the zoo
# models at batch ZOO_BATCH.
STATE_STEP = 16
TAIL_BLOCKS, TAIL_TRAIN = (1, 2, 3), 2
EXAMPLES_RES, ZOO_BATCH = 1024, 8


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


# The main path's two levels, the same two in fp32 (the route of a
# force_fp32 G: the PPL metric's), and edge cases in both dtypes: ragged H
# and W (C_in 48 is also off bf16's 64-channel chunk; the predicate's
# C_in % 16 keeps fp32's 8-channel chunks whole), N = 1 with several C_out
# tiles, no noise / clamp / demodulation.
KERNEL_CASES = (
    Case("b128.conv1", BATCH, 256, 256, 128, 128, torch.bfloat16, on_path=True),
    Case("b256.conv1", BATCH, 128, 128, 256, 256, torch.bfloat16, on_path=True),
    Case("b128.conv1 fp32", BATCH, 256, 256, 128, 128, torch.float32,
         on_path=True),
    Case("b256.conv1 fp32", BATCH, 128, 128, 256, 256, torch.float32,
         on_path=True),
    Case("edge", 3, 48, 256, 7, 136, torch.bfloat16),
    Case("plain epilogue", 2, 128, 128, 32, 128, torch.bfloat16, noise=False,
         clamp=None, demodulate=False),
    Case("3 C_out tiles", 1, 256, 384, 16, 128, torch.bfloat16),
    Case("edge fp32", 3, 48, 256, 7, 136, torch.float32),
    Case("plain epilogue fp32", 2, 128, 128, 32, 128, torch.float32,
         noise=False, clamp=None, demodulate=False),
    Case("3 C_out tiles fp32", 1, 256, 384, 16, 128, torch.float32),
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
        if src == "fused_modconv.cu":
            n, loop = sass_hot_loop(sass, "modconv_fp32_kernel")
            print(f"  modconv_fp32_kernel SASS: {n} instructions; its "
                  f"innermost loop with the most FFMA: "
                  f"{sum(loop.values())} instructions, "
                  f"{loop.get('FFMA', 0)} FFMA, {loop.get('LDS', 0)} LDS")
    for dt in (torch.bfloat16, torch.float32):
        print(f"fused_modconv conv kernel, {str(dt)[6:]}: "
              f"{fmc.smem_bytes(dt)} bytes of dynamic shared memory a block")
    print(f"build_s {build_s:.1f}")


def sass_hot_loop(sass: str, kernel: str):
    """(instructions, {opcode: count} of its innermost loop with the most
    FFMA) of the first function of ``cuobjdump -sass`` output whose name
    holds ``kernel``.  A loop runs from a backward branch's target to the
    branch; it is innermost when no other loop lies inside it.  Opcodes
    drop their modifiers (LDS.128 counts as LDS)."""
    text = sass[sass.index(kernel):]
    end = text.find("Function :")
    code = []                                   # (address, opcode, line)
    for ln in (text if end < 0 else text[:end]).splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                     ln)
        if m:
            code.append((int(m.group(1), 16), m.group(2), ln))
    loops = []                                  # (first, last) indices
    for i, (addr, op, ln) in enumerate(code):
        m = re.search(r"BRA (0x[0-9a-f]+)", ln)
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            loops.append((next(k for k, c in enumerate(code)
                               if c[0] == int(m.group(1), 16)), i))
    best = {}
    for first, last in loops:
        if any(first <= f and l < last for f, l in loops
               if (f, l) != (first, last)):
            continue
        ops = collections.Counter(c[1] for c in code[first:last + 1])
        if ops["FFMA"] > best.get("FFMA", 0):
            best = dict(ops)
    return len(code), best


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


def bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of a float32 or bfloat16 tensor, as integers."""
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int16)


def kernel_phase(peaks):
    """Each case of KERNEL_CASES: kernel vs plain, then times.  Tolerances:
    bf16, one bf16 ulp of max|y| (kernel and plain fold the taps to bf16 at
    the same places and sum in fp32, so they differ by summation order and
    may round one ulp apart); fp32, 1e-4 of max|y| (summation order over
    9 * C_in products).  The fold launch alone equals the plain fold bit for
    bit (both compute (w * s) * d in fp32 and round once to the dtype)."""
    phase("kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peak_bf16, peak_f32, hbm = peaks
    main = dict(ms=0.0, fold_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                library_ms=0.0, max_abs_err=0.0, flop_ms=0.0, byte_ms=0.0)
    fp32 = dict(main)          # the fp32 route's two levels
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
        fold = (a["w"], a["styles"], a["dcoefs"], dt)
        if not torch.equal(bits(fmc.fold_taps(*fold)),
                           bits(fmc._fold_taps_ref(*fold))):
            raise AssertionError(f"{label}: the fold launch's taps differ "
                                 f"from the plain fold")

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
              f"fold bit-equal kernel_ms {kernel_ms:.4f} "
              f"fold_ms {fold_ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} "
              f"({bound_by}) kernel_tflops {flops / kernel_ms / 1e9:.1f} "
              f"({100 * bound_ms / kernel_ms:.1f}% of the bound)", flush=True)
        if case.on_path and dt == torch.bfloat16:
            bwd = backward_case(case, a, peaks)
            for k, v in bwd.items():
                main[k] = (max(main.get(k, 0.0), v) if k.endswith("err")
                           else main.get(k, 0.0) + v)
        if case.on_path:
            agg = main if dt == torch.bfloat16 else fp32
            agg["ms"] += kernel_ms
            agg["fold_ms"] += fold_ms
            agg["plain_ms"] += plain_ms
            agg["library_ms"] += library_ms
            agg["bound_ms"] += bound_ms
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            agg["flop_ms"] += 1e3 * flops / peak_ops
            agg["byte_ms"] += 1e3 * nbytes / hbm
        del a, args, y, ref, xs
    main["fp32"] = fp32
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
    """conv1 levels outside the packed tail (packed_tail_blocks trailing
    blocks of a "skip" G, never the 4x4 one) that the predicate takes."""
    s = cfg.synthesis
    res = s.block_resolutions
    if s.packed_last_block and s.architecture == "skip":
        res = res[:len(res) - max(0, min(s.packed_tail_blocks, len(res) - 1))]
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


def run_variants(label, steps, state, real, z, key, want, cfg, card, trees,
                 check=None):
    """Each scheduled variant (SCHEDULE) once checked, then once timed with
    its peak memory: fused launches ``want`` (2 levels x the main rounds),
    finite metrics, ``cur_nimg`` advanced by the batch, every state tree of
    ``trees`` moved, ``pl_mean`` set after a Greg, and ``check(state,
    name)`` where given.  Returns (seconds, peak memory, launches of the
    checked runs, the last metrics)."""
    seconds, peak_mem, launches_total = {}, {}, 0
    batch = cfg.batch_size
    for i, name in enumerate(SCHEDULE):
        before = {k: clone_tree(getattr(state, k)) for k in trees}
        nimg = state.cur_nimg
        fmc.fused_modconv3x3.launches = 0
        state, metrics = steps[name](state, real, None, z, None,
                                     key.fold_in(i))
        torch.cuda.synchronize()
        launches = fmc.fused_modconv3x3.launches
        launches_total += launches
        shown = {k: round(float(v), 5) for k, v in metrics.items()}
        print(f"{label} {name}: fused_modconv3x3 launches {launches} "
              f"(expected {want}: 2 levels x {cfg.accum_rounds} main "
              f"rounds); {shown}")
        if launches != want:
            raise AssertionError(f"{label} {name}: {launches} launches, "
                                 f"not {want}")
        bad = [k for k, v in metrics.items()
               if not bool(torch.isfinite(v).all())]
        if bad:
            raise AssertionError(f"{label} {name}: non-finite metrics {bad}")
        if state.cur_nimg != nimg + batch:
            raise AssertionError(f"{label} {name}: cur_nimg {state.cur_nimg}")
        for k, tree in before.items():
            moved = max_change(getattr(state, k), tree)
            if not moved > 0:
                raise AssertionError(f"{label} {name}: {k} did not change")
        del before
        if name != "none" and not float(state.pl_mean) > 0:
            raise AssertionError(f"{label} {name}: pl_mean "
                                 f"{float(state.pl_mean)}")
        if check is not None:
            check(state, name)
        # The timed run of the same variant (allocator and cuDNN warm).
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = steps[name](state, real, None, z, None,
                                     key.fold_in(10 + i))
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        peak_mem[name] = torch.cuda.max_memory_allocated()
        print(f"{label} {name}: {seconds[name]:.4f} s/step, peak memory "
              f"{peak_mem[name] / 2 ** 30:.3f} GiB, pl_mean "
              f"{float(state.pl_mean):.5g} on {card}", flush=True)
    return seconds, peak_mem, launches_total, metrics


def train_phase(card, keep=None):
    """The adversarial train step at FFHQ-1024, global batch 32, with the
    JAX training CLI's 1024^2 configuration (entry.train_configs): rounds of
    8 live samples (Greg 16), bf16 ADA pipe "bgc" at p = 0.2 (ADA starts at
    0, which would leave every transform off).  The checked and timed steps
    run with PyTorch's default math (TF32 convolutions on, TF32 matmuls off);
    the pallas-vs-composed gradient check runs with TF32 off.  With a dict
    ``keep``, the steps, the final state and the inputs are left in it (for
    the state phase)."""
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
    seconds, peak_mem, launches_total, metrics = run_variants(
        "train", steps, state, real, z, key, want, cfg, card,
        ("g_params", "d_params", "g_ema"))
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
    if keep is not None:
        keep.update(steps=steps, state=state, inputs=inputs)
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


class HostRng:
    """A draw source whose draws are made on the CPU (by ``Rng``) and then
    moved to the device asked for, so that the card and the CPU see the same
    numbers."""

    def __init__(self, key):
        self.key = key

    def split(self, n):
        return [HostRng(k) for k in self.key.split(n)]

    def fold_in(self, data):
        return HostRng(self.key.fold_in(data))

    def normal(self, shape, device="cpu"):
        return self.key.normal(shape).to(device)

    def uniform(self, shape, device="cpu"):
        return self.key.uniform(shape).to(device)

    def randint(self, shape, low, high, device="cpu"):
        return self.key.randint(shape, low, high).to(device)


def wall_ms(fn, iters):
    """Host wall time per call, the card synchronised before and after (the
    exact branch reads its margin to the host inside the call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def warp_phase(card):
    """The ADA pipe of the train step (bgc in bf16, the JAX command's
    1024^2 plan) at the train phase's batch, p = 1 (every transform drawn),
    with geom_mode "fast" (the native-resolution warp, padded 1024 -> 1536)
    and "exact" (the 2x pyramid): forward and forward + backward wall ms
    and the peak memory above the inputs.  Then "fast" on the card against
    the same call on the CPU (fp32, TF32 off, draws made on the host):
    within 1e-4 of max|out|, fp32 sums over a band of 2-4 taps in another
    order (~1e-6); a wrong tap or weight misses by ~1e-1."""
    phase("warp")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, _, aug_cfg = train_configs(TRAIN_BATCH)
    x = (torch.rand((TRAIN_BATCH, 3, WARP_RES, WARP_RES),
                    generator=torch.Generator().manual_seed(9)) * 2
         - 1).to(DEVICE)
    out = {}
    for mode in ("fast", "exact"):
        cfg = dataclasses.replace(aug_cfg, geom_mode=mode)

        def fwd():
            with torch.no_grad():
                return augment.augment_pipe(cfg, x, 1.0, Rng(7))

        xg = x.clone().requires_grad_(True)

        def fwd_bwd():
            y = augment.augment_pipe(cfg, xg, 1.0, Rng(7))
            y.float().square().mean().backward()
            xg.grad = None

        y = fwd()
        if (tuple(y.shape) != tuple(x.shape) or y.dtype != x.dtype
                or not bool(torch.isfinite(y).all())):
            raise AssertionError(f"warp {mode}: {y.dtype} {tuple(y.shape)}")
        del y
        peaks = []
        for fn in (fwd, fwd_bwd):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peaks.append((torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        out[mode] = (wall_ms(fwd, WARP_ITERS), wall_ms(fwd_bwd, WARP_ITERS),
                     *peaks)
        del xg
        torch.cuda.empty_cache()
    for mode, (f, fb, pf, pfb) in out.items():
        print(f"ADA pipe bgc bf16, batch {TRAIN_BATCH}, {WARP_RES}^2, p = 1, "
              f"geom_mode {mode}: forward {f:.3f} ms ({pf:.3f} GiB peak "
              f"above the inputs), forward+backward {fb:.3f} ms ({pfb:.3f} "
              f"GiB), on {card}", flush=True)

    cfg = dataclasses.replace(augment.make_config("bgc"), geom_mode="fast")
    small = torch.rand((WARP_CHECK_BATCH, 3, WARP_CHECK_RES, WARP_CHECK_RES),
                       generator=torch.Generator().manual_seed(4)) * 2 - 1
    want = augment.augment_pipe(cfg, small, 1.0, HostRng(Rng(3)))
    got = augment.augment_pipe(cfg, small.to(DEVICE), 1.0,
                               HostRng(Rng(3))).cpu()
    err = float((got - want).abs().max())
    peak = float(want.abs().max())
    moved = float((want - small).abs().max())
    print(f"fast warp, card vs CPU (bgc fp32, {WARP_CHECK_BATCH} x "
          f"{WARP_CHECK_RES}^2, p = 1): max_abs_err {err:.4g} (bound "
          f"{1e-4 * peak:.4g} = 1e-4 max|out|; the pipe moved pixels by "
          f"up to {moved:.4g})")
    torch.backends.cudnn.allow_tf32 = True
    if not (err <= 1e-4 * peak and moved > 1e-2):
        raise AssertionError("fast warp: card and CPU disagree")
    return out


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


def png_filter_rows(data: bytes) -> collections.Counter:
    """The rows of a PNG by filter type (0-4)."""
    import struct
    import zlib

    pos, idat, w, c = 8, [], 0, 0
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            w = struct.unpack(">I", data[pos + 8:pos + 12])[0]
            c = {0: 1, 2: 3, 4: 2, 6: 4}[data[pos + 17]]
        elif tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    raw = zlib.decompress(b"".join(idat))
    return collections.Counter(raw[::w * c + 1])


def dataset_phase(tmp, card):
    """The dataset tool and both loaders on the loop's data: LOOP_IMAGES
    seeded 1024^2 images (64^2 noise, Pillow-bicubic upsampled) written as
    unfiltered PNGs (the folder the later phases read), converted by
    data/dataset_tool.py into a zip (Pillow's per-row filter choice: Sub
    and Paeth rows), then read back
    by NativeZipDataset (the C++ loader, built here with g++ and zlib) and
    by ImageFolderDataset: equal pixels, labels and order (the first
    LOOP_BATCH images by index, in one read_batch and in one threaded batch
    as data_loader makes it), and each one's time for that batch.  Returns
    the zip and whether the native loader is available."""
    phase("dataset")
    src, zpath = os.path.join(tmp, "data"), os.path.join(tmp, "data.zip")
    os.makedirs(src)
    rng = np.random.RandomState(0)
    labels = []
    n = max(LOOP_RES // 16, 4)
    for i in range(LOOP_IMAGES):
        img = resize_uint8(rng.randint(0, 256, (n, n, 3)).astype(np.uint8),
                           (LOOP_RES, LOOP_RES), "bicubic")
        name = f"{i:05d}.png"
        png.write_png(os.path.join(src, name), img, level=1)
        labels.append([name, i % 4])
    with open(os.path.join(src, "dataset.json"), "w") as f:
        json.dump({"labels": labels}, f)
    t0 = time.perf_counter()
    dataset_tool.main(["--source", src, "--dest", zpath])
    tool_s = time.perf_counter() - t0
    import zipfile
    rows = collections.Counter()
    with zipfile.ZipFile(zpath) as z:
        names = sorted(n for n in z.namelist() if n.endswith(".png"))
        for n in names:
            rows += png_filter_rows(z.read(n))
    print(f"dataset_tool: {len(names)} PNGs of {LOOP_RES}^2 in "
          f"{os.path.getsize(zpath) / 2 ** 20:.1f} MiB, {tool_s:.2f} s on "
          f"the host of {card}; rows by filter type "
          f"{dict(sorted(rows.items()))}", flush=True)
    if len(names) != LOOP_IMAGES or rows[4] == 0:
        raise AssertionError("dataset_tool: wrong images or no Paeth rows")

    idxs = list(range(LOOP_BATCH))
    py = ImageFolderDataset(zpath, use_labels=True)
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=4) as pool:
        items = list(pool.map(py.__getitem__, idxs))
    py_ms = (time.perf_counter() - t0) * 1e3
    py_imgs = np.stack([im for im, _ in items])
    py_labels = np.stack([lb for _, lb in items])
    if not native_loader.native_available():
        print(f"native loader: not available on {card}: "
              f"{native_loader.build_error()}; the phase checks "
              f"ImageFolderDataset alone: a batch of {LOOP_BATCH} in "
              f"{py_ms:.1f} ms", flush=True)
        return zpath, False
    nat = native_loader.NativeZipDataset(zpath, use_labels=True)
    t0 = time.perf_counter()
    nat_imgs, nat_labels = nat.read_batch(idxs)
    nat_ms = (time.perf_counter() - t0) * 1e3
    same = (np.array_equal(nat_imgs, py_imgs)
            and np.array_equal(nat_labels, py_labels)
            and len(nat) == len(py) and nat.image_shape == py.image_shape)
    nat.close()
    print(f"read a batch of {LOOP_BATCH} {LOOP_RES}^2 PNGs: NativeZipDataset "
          f"{nat_ms:.1f} ms, ImageFolderDataset (4 threads) {py_ms:.1f} ms "
          f"({py_ms / nat_ms:.1f}x); pixels, labels and order equal {same}; "
          f"on the host of {card}", flush=True)
    if not same:
        raise AssertionError("native and folder readers disagree")
    return zpath, True


def loop_phase(tmp, card, train_sec_per_kimg):
    """A training run through the command users start, at FFHQ-1024 on
    the dataset phase's zip of LOOP_IMAGES PNGs (read by the native loader
    where it builds), --kimg 1 at --batch 32: the loop's plan gives
    main rounds of 8 (fused level in G's forward, 2 levels a round), Greg
    rounds of 16 (pallas_level off) and R1 with a remat'd D.  Returns the
    run dir, the fused launches, the loop's own sec/kimg and the zip."""
    data, native = dataset_phase(tmp, card)
    phase("loop")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    run_dir = os.path.join(tmp, "run")
    loaders, taken = [], []
    orig_loader = loop_lib.data_loader
    orig_native = loop_lib.nl.native_data_loader

    def timed(name, fn):
        def make(*a, **k):
            taken.append(name)
            loaders.append(TimedLoader(fn(*a, **k)))
            return loaders[-1]
        return make

    loop_lib.data_loader = timed("data_loader (ImageFolderDataset)",
                                 orig_loader)
    loop_lib.nl.native_data_loader = timed(
        "native_data_loader (NativeZipDataset)", orig_native)
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
        loop_lib.nl.native_data_loader = orig_native
    wall = time.perf_counter() - t0
    print(f"loop: cli/train.py --data {os.path.basename(data)} read by "
          f"{taken}")
    if taken != ["native_data_loader (NativeZipDataset)" if native
                 else "data_loader (ImageFolderDataset)"]:
        raise AssertionError(f"loop: loader {taken}, native available "
                             f"{native}")
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
          f"sec_per_kimg, the fast warp; the train phase's schedule: "
          f"{train_sec_per_kimg:.4f} s/kimg; before the fast warp and the "
          f"zip: {LOOP_SEC_PER_KIMG_BEFORE}); waited {wait:.4f} s on the "
          f"loader ({100 * wait / wall:.2f}% of the command's {wall:.2f} s); "
          f"the tick includes the first steps' warm-up; on {card}",
          flush=True)
    png_decode_rate(tmp, card)
    return snap, launches, sec_per_kimg, data


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
    """The generator of the adapt, im2im and ga phases: FFHQ-1024 as
    entry_config() (8 mapping layers, pallas_level=True)."""
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
    fmc.fused_modconv3x3.launches = 0
    t0 = time.perf_counter()
    with BackwardNeeds() as needs:
        trainer = adapt_cli.main(
            ["--config", os.path.join(REPO, ADAPT_CONFIG), "--network", snap,
             "--outdir", out, "--device", DEVICE] + overrides)
        torch.cuda.synchronize()
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
    needs.check("adapt", want)
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
    trace_window(trainer.train_step_async, f"one adapt step (batch "
                 f"{trainer.cfg.batch_size}, pallas_level=True)", card,
                 1e3 / rate)
    return rate


def trace_window(fn, label, card, step_ms, top=12, ranges=()):
    """One torch.profiler trace of ``fn()``: the kernels with the most
    device time, the fused level's forward (fold + conv) and backward
    shares, the device time of the kernels launched inside each
    ``record_function`` range named in ``ranges``, the share of the
    window's wall time (the "traced_window" range, which ends in a
    synchronize) with no kernel, copy or fill running on the card, and that
    share of the unprofiled window (``step_ms``, timed apart)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("traced_window"):
            fn()
            torch.cuda.synchronize()
    device_us, spans, bwd_us, wall_us = {}, [], 0.0, 0.0
    launch_us, launches, syncs = 0.0, 0, {}
    range_us = {name: 0.0 for name in ranges}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if evt.name in ("traced_window", "fused_modconv3x3_bwd") + ranges:
                continue
            device_us[evt.name] = (device_us.get(evt.name, 0.0)
                                   + evt.time_range.elapsed_us())
            spans.append((evt.time_range.start, evt.time_range.end))
        elif evt.name == "traced_window":
            wall_us = evt.time_range.elapsed_us()
        elif evt.name == "fused_modconv3x3_bwd":
            bwd_us += evt.device_time_total
        elif evt.name in range_us:
            range_us[evt.name] += evt.device_time_total
        elif evt.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx"):
            launch_us += evt.time_range.elapsed_us()
            launches += 1
        elif evt.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaMemcpyAsync", "cudaMemcpy"):
            n, us = syncs.get(evt.name, (0, 0.0))
            syncs[evt.name] = (n + 1, us + evt.time_range.elapsed_us())
    total = sum(device_us.values())
    print(f"trace of {label} on {card}:")
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
    print(f"  wall {wall_us / 1e3:.4f} ms, device busy {busy / 1e3:.4f} "
          f"ms: {100 * (1 - busy / wall_us):.2f}% of it with no kernel "
          f"on the card; kernel time {total / 1e3:.4f} ms, fused level "
          f"forward {fwd / 1e3:.4f} ms ({100 * fwd / total:.2f}%), its "
          f"backward {bwd_us / 1e3:.4f} ms ({100 * bwd_us / total:.2f}%)"
          + "".join(f"; range {name!r} {us / 1e3:.4f} ms "
                    f"({100 * us / total:.2f}%)"
                    for name, us in range_us.items()))
    print(f"  unprofiled {step_ms:.4f} ms (timed apart): "
          f"{100 * max(0.0, 1 - busy / 1e3 / step_ms):.2f}% of it with no "
          f"kernel on the card, at this trace's device busy time")
    print(f"  host: {launches} kernel launches, {launch_us / 1e3:.4f} ms in "
          f"the launch calls ({len(spans)} kernels, copies and fills on the "
          f"card); the profiler's own cost is in the wall time")
    print("  host waits and copies: " + (", ".join(
        f"{name} x{n} {us / 1e3:.4f} ms" for name, (n, us) in sorted(
            syncs.items())) or "none"))


def fewshot_parts():
    """entry.FEWSHOT_OPTIONS' G parts, with the weight offsets on block
    b<FEWSHOT_BLOCK>."""
    return FEWSHOT_OPTIONS["generator_requires_grad_parts"].replace(
        ".b64", f".b{FEWSHOT_BLOCK}")


def fewshot_flags():
    """cli/train.py's few-shot options (entry.FEWSHOT_OPTIONS)."""
    return ["--use-domain-modulation", "--domain-modulation-parametrization",
            FEWSHOT_OPTIONS["domain_modulation_parametrization"],
            "--generator-requires-grad-parts", fewshot_parts(),
            "--glrate", str(FEWSHOT_OPTIONS["glrate"])]


def fewshot_run(batch):
    """entry.fewshot_entry's run (its configs and parts)."""
    return train_run(batch, **FEWSHOT_OPTIONS)


class BackwardNeeds:
    """Records what each call of the fused level's backward is asked for:
    (dx, dW, dstyles, ddcoefs, dnoise, dbias)."""

    def __init__(self):
        self.calls = []
        self._bwd = None

    def __enter__(self):
        self._bwd = fmc.fused_modconv3x3_bwd

        def recording_bwd(*args, **kw):
            self.calls.append(tuple(kw["needs"]))
            return self._bwd(*args, **kw)

        fmc.fused_modconv3x3_bwd = recording_bwd
        return self

    def __exit__(self, *exc):
        fmc.fused_modconv3x3_bwd = self._bwd

    def count(self, flags) -> int:
        """Calls asked for exactly ``flags``."""
        return sum(n == tuple(flags) for n in self.calls)

    def check(self, label, want_calls):
        """Every call asked for dx and d(styles), none for dW."""
        if len(self.calls) != want_calls or any(
                n[1] or not (n[0] and n[2]) for n in self.calls):
            raise AssertionError(
                f"{label}: the fused level's backward was asked for "
                f"{sorted(set(self.calls))} in {len(self.calls)} calls "
                f"(expected {want_calls}, never dW)")
        print(f"{label}: fused backward needs (dx, dW, dstyles, ddcoefs, "
              f"dnoise, dbias) = {sorted(set(self.calls))} in "
              f"{len(self.calls)} calls: no dW")


def fewshot_phase(tmp, snap, card):
    """Few-shot Affine+ adaptation (cli/train.py --use-domain-modulation),
    as bench.py::bench_adapt10 shapes it: the conversion, the command, the
    timed variants, pallas vs composed gradients and the layer probe.
    Returns (fused launches, s/step by variant, peak memory by variant,
    scheduled s/kimg)."""
    phase("fewshot")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    resume = convert_snapshot(tmp, snap)
    launches = fewshot_cli_run(tmp, resume, card)
    torch.cuda.empty_cache()
    steps, state, (real, _, z, _, key) = fewshot_entry(
        DEVICE, batch=TRAIN_BATCH, ada_p=0.2)
    run = fewshot_run(TRAIN_BATCH)
    cfg = run.train_cfg
    live = cfg.batch_size // cfg.accum_rounds
    want = expected_launches(run.g_cfg, live) * cfg.accum_rounds
    gmask = ckpt.tree_to_flat_tensors(masks_lib.generator_mask(
        state.g_params, run.parts))
    frozen = {k: t.clone() for k, t in ckpt.tree_to_flat_tensors(
        state.g_params).items()
        if not gmask[k] and not k.endswith("w_avg")}

    def g_frozen_unchanged(state, name):
        flat = ckpt.tree_to_flat_tensors(state.g_params)
        moved = [k for k, t in frozen.items() if not torch.equal(flat[k], t)]
        if moved:
            raise AssertionError(f"fewshot {name}: frozen G leaves moved: "
                                 f"{moved[:4]}")

    seconds, peak_mem, n, _ = run_variants(
        "fewshot", steps, state, real, z, key, want, cfg, card,
        ("g_params", "d_params", "g_ema", "offsets", "offsets_ema"),
        check=g_frozen_unchanged)
    launches += n
    sec_per_batch = sum(SCHEDULE[k] * seconds[k] for k in SCHEDULE) / 16
    print(f"fewshot {run.parametrization} FFHQ-1024 batch {TRAIN_BATCH}: "
          f"{sec_per_batch / TRAIN_BATCH * 1000:.4f} s/kimg ((12 none + 3 "
          f"greg + 1 both) / 16 = {sec_per_batch:.4f} s/batch); "
          f"{len(frozen)} frozen G leaves bit-equal after every variant, on "
          f"{card}", flush=True)
    launches += fewshot_grads_check(run, state, real[:live], z[:live],
                                    key.fold_in(30))
    launches += probe_check(run.g_cfg, state.g_params, card)
    return launches, seconds, peak_mem, sec_per_batch / TRAIN_BATCH * 1000


def nvlabs_buffers(flat):
    """The resample-filter buffers NVlabs modules carry beside these
    weights: one per block and one per conv layer."""
    taps = torch.tensor([1.0, 3.0, 3.0, 1.0])
    f = torch.outer(taps, taps) / 64
    out = {}
    for k, v in flat.items():
        parts = k.split(".")
        if (parts[-1] == "weight" and v.dim() == 4
                and parts[-2] in ("conv0", "conv1", "fromrgb", "skip")):
            out[".".join(parts[:-1] + ["resample_filter"])] = f
            out[".".join(parts[:-2] + ["resample_filter"])] = f
    return out


def convert_snapshot(tmp, snap):
    """The loop's snapshot as NVlabs-layout state dicts (torch.save of
    {"G", "G_ema", "D"}, resample filters added) through the converter
    command; the npz must hold every tensor bit for bit and no filter."""
    trees, _ = ckpt.load_snapshot(snap)
    nets, dropped = {}, {}
    for name in ("G", "G_ema", "D"):
        flat = ckpt.tree_to_flat_tensors(trees[name])
        dropped[name] = nvlabs_buffers(flat)
        nets[name] = {**flat, **dropped[name]}
    src = os.path.join(tmp, "nvlabs_nets.pt")
    dest = os.path.join(tmp, "converted.npz")
    torch.save(nets, src)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "gagan_tpu_torch.cli.convert_weights",
                    "nvlabs", "--src", src, "--dest", dest], cwd=REPO,
                   check=True, timeout=600)
    wall = time.perf_counter() - t0
    with np.load(dest) as data:
        files = set(data.files)
        for name, tensors in nets.items():
            for k, t in tensors.items():
                key = f"{name}/{k}"
                if k in dropped[name]:
                    if key in files:
                        raise AssertionError(f"convert: {key} kept")
                elif key not in files or not np.array_equal(
                        data[key], t.numpy()):
                    raise AssertionError(f"convert: {key} differs")
    n_kept = sum(len(v) - len(dropped[k]) for k, v in nets.items())
    n_drop = sum(len(v) for v in dropped.values())
    print(f"convert nvlabs: {n_kept} tensors bit-equal, {n_drop} resample "
          f"filters dropped, in {wall:.2f} s (the command's process)")
    return dest


def fewshot_cli_run(tmp, resume, card):
    """cli/train.py with the few-shot options on the loop phase's PNGs,
    resumed from ``resume``, the loop's length cut to FEWSHOT_KIMG.
    Checks the files, the offsets, the frozen and moved leaves, the fused
    launches and their backward's flags, and generate --s-direction on the
    result.  Returns the fused launches."""
    data, run_dir = os.path.join(tmp, "data"), os.path.join(tmp, "fewshot")
    orig = loop_lib.training_loop

    def cut(loop_cfg, *a, **k):
        loop_cfg.total_kimg = FEWSHOT_KIMG
        return orig(loop_cfg, *a, **k)

    loop_lib.training_loop = cut
    fmc.fused_modconv3x3.launches = 0
    t0 = time.perf_counter()
    try:
        with BackwardNeeds() as needs:
            state = train_cli.main([
                "--data", data, "--outdir", run_dir, "--gpus", "1", "--cfg",
                "auto", "--batch", str(LOOP_BATCH), "--kimg", "1", "--snap",
                "1", "--resume", resume, "--seed", "0", "--device", DEVICE]
                + fewshot_flags())
            torch.cuda.synchronize()
    finally:
        loop_lib.training_loop = orig
    wall = time.perf_counter() - t0
    launches = fmc.fused_modconv3x3.launches
    run = train_cli.build_run(LOOP_RES, batch=LOOP_BATCH)
    rounds = run.train_cfg.accum_rounds
    batches = state.cur_nimg // LOOP_BATCH
    grid_n = run.loop_cfg.grid_size[0] * run.loop_cfg.grid_size[1]
    train_launches = (expected_launches(run.g_cfg, LOOP_BATCH // rounds)
                      * rounds * batches)
    want = train_launches + expected_launches(run.g_cfg, grid_n)
    print(f"fewshot cli: {batches} batches in {wall:.2f} s with the resume "
          f"and the files; fused_modconv3x3 launches {launches} (expected "
          f"{want}: 2 levels x {rounds} main rounds x {batches} batches + 2 "
          f"for the grid), on {card}", flush=True)
    if state.cur_nimg != round(FEWSHOT_KIMG * 1000) or launches != want:
        raise AssertionError(f"fewshot cli: {state.cur_nimg} images, "
                             f"{launches} launches")
    needs.check("fewshot cli", train_launches)

    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    if len(lines) != 1 or not all(np.isfinite(lines[0].get(k, np.nan)) for k in
                                  ("Loss/G/loss", "Loss/D/loss",
                                   "Timing/sec_per_kimg")):
        raise AssertionError(f"fewshot stats.jsonl: {lines}")
    kimg = state.cur_nimg // 1000
    snap = os.path.join(run_dir, f"network-snapshot-{kimg:06d}.npz")
    adaptation = os.path.join(run_dir, f"adaptation-{kimg:06d}.npz")
    meta, offsets, _ = ckpt.load_adaptation(adaptation)
    names = [f"b{FEWSHOT_BLOCK}.{n}" for n in ("conv0", "conv1", "torgb")]
    if (meta["parametrization"] != "out_in_additive"
            or sorted(offsets) != names
            or any(sorted(offsets[n]) != ["weights_offset"] for n in names)
            or not all(float(offsets[n]["weights_offset"].abs().max()) > 0
                       for n in names)):
        raise AssertionError(f"fewshot: {adaptation} holds {meta}, "
                             f"{ {n: sorted(v) for n, v in offsets.items()} }")

    # G's frozen leaves are the resumed ones; its affines and D moved.
    resumed, _ = ckpt.load_snapshot(resume)
    src_g = ckpt.tree_to_flat(resumed["G"])
    got_g = ckpt.tree_to_flat(state.g_params)
    gmask = ckpt.tree_to_flat(masks_lib.generator_mask(
        state.g_params, tuple(fewshot_parts().split(","))))
    frozen = [k for k in src_g if not gmask[k] and not k.endswith("w_avg")]
    trained = [k for k in src_g if gmask[k]]
    if any(not np.array_equal(got_g[k], src_g[k]) for k in frozen):
        raise AssertionError("fewshot: a frozen G leaf moved")
    if not all(".affine." in k for k in trained) or not any(
            not np.array_equal(got_g[k], src_g[k]) for k in trained):
        raise AssertionError("fewshot: G's affines did not train")
    if max_change(state.d_params, ckpt.flat_to_tree(
            ckpt.tree_to_flat(resumed["D"]), DEVICE)) <= 0:
        raise AssertionError("fewshot: D did not move")
    print(f"fewshot: {os.path.basename(adaptation)} holds {names} "
          f"(max|offset| {max(float(offsets[n]['weights_offset'].abs().max()) for n in names):.6f}); "
          f"{len(frozen)} frozen G leaves bit-equal to the resumed ones, "
          f"{len(trained)} affine leaves and D moved, on {card}")

    # generate from the snapshot with and without the offsets.
    outs, gen_launches = {}, 0
    for label, extra in (("plain", []), ("offsets", ["--s-direction",
                                                     adaptation])):
        outs[label] = os.path.join(run_dir, "gen_" + label)
        fmc.fused_modconv3x3.launches = 0
        generate.main(["--network", snap, "--seeds", "0", "--outdir",
                       outs[label], "--device", DEVICE] + extra)
        torch.cuda.synchronize()
        gen_launches += fmc.fused_modconv3x3.launches
        check_pngs(outs[label], ["seed0000.png"], (LOOP_RES, LOOP_RES, 3))
    differ = not np.array_equal(
        png.read_png(os.path.join(outs["plain"], "seed0000.png")),
        png.read_png(os.path.join(outs["offsets"], "seed0000.png")))
    want_gen = 2 * expected_launches(run.g_cfg, 1)
    print(f"fewshot generate --s-direction {os.path.basename(adaptation)}: "
          f"differs from plain {differ}; fused_modconv3x3 launches "
          f"{gen_launches} (expected {want_gen}), on {card}")
    if not differ or gen_launches != want_gen:
        raise AssertionError("fewshot generate --s-direction failed")
    return launches + gen_launches


def fewshot_grads_check(run, state, real, z, key):
    """One simultaneous main round at the live batch with pallas_level
    True and False on the same state, offsets and draws, TF32 off: the
    gradients of G's trainable affines and of the trainable offsets.  As
    in the train phase's check, the fused levels round at other places
    than the composed path and the fakes differ by about 1% RMS, so every
    gradient downstream differs by about as much; bounds: relative L2 over
    all of them <= 2^-4, and <= 2^-2 for each affine leaf of the two fused
    levels.  A wrong backward formula or layout errs by O(100%).  Returns
    the fused launches."""
    torch.backends.cudnn.allow_tf32 = False
    g_cfg, d_cfg, cfg = run.g_cfg, run.d_cfg, run.train_cfg
    spec = offs_lib.OffsetsSpec.from_string(run.parametrization,
                                            weight_parts=run.parts)
    gmask = ckpt.tree_to_flat_tensors(masks_lib.generator_mask(
        state.g_params, run.parts))
    affines = {k: t for k, t in ckpt.tree_to_flat_tensors(
        state.g_params).items() if gmask[k]}
    augment_fn = augment.make_augment_fn(run.augment_cfg)
    plain = dataclasses.replace(g_cfg, synthesis=dataclasses.replace(
        g_cfg.synthesis, pallas_level=False))
    grads, launches = {}, 0
    for label, gc in (("pallas", g_cfg), ("composed", plain)):
        fmc.fused_modconv3x3.launches = 0
        with BackwardNeeds() as needs:
            _, _, grads[label] = round_grads(lambda: gan_loss.gd_main_loss(
                cfg.loss, gc, d_cfg, state.g_params, state.d_params, real,
                None, z, None, key, augment_fn, state.ada_p,
                hooks=offs_lib.make_hooks(spec, state.offsets)),
                {"G": affines, "O": state.offsets})
            torch.cuda.synchronize()
        launches += fmc.fused_modconv3x3.launches
        if label == "pallas":
            needs.check("fewshot gradient check", expected_launches(
                g_cfg, len(z)))
    torch.backends.cudnn.allow_tf32 = True
    a, b = grads["pallas"], grads["composed"]
    err = rel_l2(a, b, list(a))
    o_err = rel_l2(a, b, [k for k in a if k.startswith("O/")])
    level = {k: rel_l2(a, b, [k]) for k in a
             if ".b128.conv1." in k or ".b256.conv1." in k}
    print(f"fewshot pallas vs composed gradients (TF32 off, live batch "
          f"{len(z)}): G affines + offsets rel_l2 {err:.4g}, offsets alone "
          f"{o_err:.4g} (bound {2 ** -4:.4g}); "
          + ", ".join(f"{k} {v:.4g}" for k, v in level.items())
          + f" (bound {2 ** -2:.4g})")
    if not (err <= 2 ** -4 and all(v <= 2 ** -2 for v in level.values())):
        raise AssertionError("fewshot: pallas and composed gradients "
                             "disagree")
    return launches


def probe_check(g_cfg, g_params, card):
    """One adaptive layer probe (train/auto_layers.py) on the few-shot G:
    PROBE_ITERS SGD steps on W+ at batch PROBE_BATCH against a random
    ViT-B/32's global loss; every score finite, PROBE_K names back, and
    the fused level's backward asked for dx and d(styles) only.  Returns
    the fused launches."""
    (ccfg, cparams), = adapt_cli.load_clip_encoders(
        ("ViT-B/32",), DEVICE, ADAPT_CLIP_OVERRIDES).values()
    target = torch.randn((1, ccfg.embed_dim),
                         generator=torch.Generator().manual_seed(6)).to(DEVICE)
    fmc.fused_modconv3x3.launches = 0
    t0 = time.perf_counter()
    with BackwardNeeds() as needs:
        chosen, scores = auto_layers.determine_opt_layers(
            Rng(21), g_cfg, g_params, ccfg, cparams, target,
            auto_layer_iters=PROBE_ITERS, auto_layer_batch=PROBE_BATCH,
            auto_layer_k=PROBE_K)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fmc.fused_modconv3x3.launches
    want = PROBE_ITERS * expected_launches(g_cfg, PROBE_BATCH)
    print(f"auto-layer probe ({PROBE_ITERS} iterations, batch {PROBE_BATCH}) "
          f"in {wall:.2f} s: {len(scores)} scores "
          f"{[round(float(v), 6) for v in scores]}, chosen {chosen}; "
          f"fused_modconv3x3 launches {launches} (expected {want}), on {card}")
    if (tuple(scores.shape) != (g_cfg.num_ws,)
            or not bool(torch.isfinite(scores).all())
            or len(chosen) != PROBE_K
            or not set(chosen) <= set(g_cfg.synthesis.layer_names())
            or launches != want):
        raise AssertionError("auto-layer probe failed")
    needs.check("auto-layer probe", want)
    return launches


# ----------------------------------------------------------------------------
# The im2im phase: projection and the image-driven trainers


# The level's backward flags (dx, dW, dstyles, ddcoefs, dnoise, dbias) of a
# projector step: the latent and the noise buffers take gradients, G's
# weights do not.
PROJECT_NEEDS = (True, False, True, True, True, False)


def im2im_phase(card):
    """Projection through cli/projector.py, the three image-driven configs
    through cli/adapt.py, the DiFa step of bench.py timed, and pallas vs
    composed gradients of a DiFa step and of a projector step.  Returns
    (fused launches of the commands, their backward flags, DiFa steps/s)."""
    phase("im2im")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    g_cfg = adapt_g_config()
    params = seeded_weights(sg2.init_generator(
        g_cfg, torch.Generator().manual_seed(0), DEVICE))
    flags = set()
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "ffhq1024.npz")
        ckpt.save_snapshot(snap, g_ema=params,
                           config={"g_cfg": config_lib.to_dict(g_cfg)})
        style = os.path.join(tmp, "style.png")
        z = torch.from_numpy(np.random.RandomState(42).randn(
            1, g_cfg.z_dim).astype(np.float32)).to(DEVICE)
        with torch.no_grad():
            png.write_png(style, generate.to_uint8(sg2.generator_apply(
                g_cfg, params, z, noise_mode="const"))[0])
        launches = projector_cli_run(tmp, snap, style, g_cfg, card, flags)
        for config in IM2IM_CONFIGS:
            torch.cuda.empty_cache()
            launches += im2im_cli_run(tmp, snap, style, config, g_cfg, card,
                                      flags)
    torch.cuda.empty_cache()
    rate = im2im_timing(params, card)
    torch.cuda.empty_cache()
    im2im_grads_check(params, card)
    return launches, sorted(flags), rate


def projector_cli_run(tmp, snap, style, g_cfg, card, flags):
    """cli/projector.py on the style PNG for PROJECT_STEPS steps in w space
    with --save-image; returns the fused launches."""
    out = os.path.join(tmp, "projection")
    fmc.fused_modconv3x3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with BackwardNeeds() as needs:
        results = projector_cli.main(
            ["--network", snap, "--target", style, "--outdir", out,
             "--space", "w", "--num-steps", str(PROJECT_STEPS),
             "--save-image", "--device", DEVICE])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = fmc.fused_modconv3x3.launches
    per = expected_launches(g_cfg, 1)
    want = per * (PROJECT_STEPS + 1)
    (_, w_plus, dists), = results
    with np.load(os.path.join(out, "projected_w.npz")) as f:
        w = f["w"]
    res = g_cfg.img_resolution
    check_pngs(out, ["style_proj.png", "style_target.png"], (res, res, 3))
    print(f"projector cli: {PROJECT_STEPS} steps at {res}^2 batch 1 in "
          f"{wall:.2f} s with set-up ({wall / PROJECT_STEPS:.4f} s/step "
          f"including it), peak memory {peak / 2 ** 30:.3f} GiB; LPIPS "
          f"distance at step 1 {dists[0]:.6f}, at step {PROJECT_STEPS} "
          f"{dists[-1]:.6f} (random VGG16: no decrease required); "
          f"projected_w {w.shape}; fused_modconv3x3 launches {launches} "
          f"(expected {want}: {per} a step and {per} for the re-synthesis), "
          f"on {card}", flush=True)
    if (w.shape != (1, g_cfg.num_ws, g_cfg.w_dim) or not np.isfinite(w).all()
            or not np.array_equal(w[0], w_plus) or len(dists) != PROJECT_STEPS
            or not np.isfinite(dists).all() or launches != want):
        raise AssertionError("projector cli failed")
    calls = per * PROJECT_STEPS
    if len(needs.calls) != calls or needs.count(PROJECT_NEEDS) != calls:
        raise AssertionError(
            f"projector: the fused level's backward was asked for "
            f"{sorted(set(needs.calls))} in {len(needs.calls)} calls, not "
            f"{PROJECT_NEEDS} in {calls}")
    print(f"projector: fused backward needs (dx, dW, dstyles, ddcoefs, "
          f"dnoise, dbias) = {sorted(set(needs.calls))} in "
          f"{len(needs.calls)} calls: d(noise), no dW")
    flags.update(needs.calls)
    # The steady step: the same projection called directly, timed from the
    # end of its first step (one synchronize there) to its return (the
    # latents' host copy).
    target = png.read_png(os.path.join(out, "style_target.png"))
    marks = []

    def mark(step, dist, grads):
        if step == 0:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

    projector.project(*generate.load_generator(snap, DEVICE),
                      target.transpose(2, 0, 1), num_steps=PROJECT_STEPS,
                      rng=Rng(303), on_step=mark)
    steady = (time.perf_counter() - marks[0]) / (PROJECT_STEPS - 1)
    print(f"projector step at {res}^2 batch 1: {steady:.4f} s/step (steps "
          f"2-{PROJECT_STEPS}, random VGG16-LPIPS), on {card}", flush=True)
    return launches


def im2im_cli_run(tmp, snap, style, config, g_cfg, card, flags):
    """cli/adapt.py on configs/<config>.yaml with the style PNG, projected
    for IM2IM_INVERSION steps, trained for IM2IM_ITERS; returns the fused
    launches."""
    out = os.path.join(tmp, config)
    overrides = [f"training.target_class={style}",
                 f"training.iter_num={IM2IM_ITERS}",
                 f"checkpointing.step_backup={IM2IM_ITERS}",
                 f"logging.log_every={IM2IM_LOG}",
                 f"inversion.steps={IM2IM_INVERSION}"]
    if ADAPT_CLIP_OVERRIDES:
        overrides += [
            f"training.clip_config_overrides={ADAPT_CLIP_OVERRIDES!r}",
            "training.clip_layer=1"]
    fmc.fused_modconv3x3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with BackwardNeeds() as needs:
        trainer = adapt_cli.main(
            ["--config", os.path.join(REPO, "configs", f"{config}.yaml"),
             "--network", snap, "--outdir", out, "--device", DEVICE]
            + overrides)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = fmc.fused_modconv3x3.launches
    cfg = trainer.cfg
    batch = cfg.batch_size
    project = expected_launches(g_cfg, 1) * IM2IM_INVERSION
    if cfg.trainer == "im2im_JoJo":   # the mixed style latents' render only
        step = expected_launches(g_cfg, batch)
    else:      # the joint pass, and the style latents' render if it is read
        step = (expected_launches(g_cfg, 2 * batch)
                + expected_launches(g_cfg, 1) * trainer.renders_style_latents)
    want = project + step * IM2IM_ITERS
    print(f"adapt cli {config}.yaml ({cfg.trainer}, {cfg.parametrization}, "
          f"batch {batch}, {'+'.join(cfg.loss.loss_funcs)}"
          f"{'+difa_w' if cfg.loss.scc else ''}): projection "
          f"{IM2IM_INVERSION} steps and {IM2IM_ITERS} steps in {wall:.2f} s "
          f"with the build of the towers, peak memory {peak / 2 ** 30:.3f} "
          f"GiB; fused_modconv3x3 launches {launches} (expected {want}), on "
          f"{card}", flush=True)
    if launches != want:
        raise AssertionError(f"{config}: {launches} launches, not {want}")
    needs.check(config, want)
    if needs.count(PROJECT_NEEDS) != project:
        raise AssertionError(f"{config}: {needs.count(PROJECT_NEEDS)} "
                             f"backward calls with d(noise), not {project}")
    flags.update(needs.calls)

    with open(os.path.join(out, "losses.jsonl")) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    if ([ln["step"] for ln in lines] != list(range(0, IM2IM_ITERS, IM2IM_LOG))
            or not all(np.isfinite(v) for ln in lines for v in ln.values())
            or ("difa_psp_loss" in lines[0]) != (config == "im2im_difa")):
        raise AssertionError(f"{config}: losses.jsonl {lines}")
    print(f"{config} losses.jsonl: " + "; ".join(
        f"step {ln['step']} " + ", ".join(f"{k} {v:.6f}" for k, v in
                                          ln.items() if k != "step")
        for ln in lines))
    npz = os.path.join(out, f"adaptation-{IM2IM_ITERS:06d}.npz")
    _, offsets, _ = ckpt.load_adaptation(npz)
    moved = max(float(t.abs().max()) for t in leaves_of([offsets]))
    trees, _ = ckpt.load_snapshot(snap, DEVICE)
    loaded = ckpt.tree_to_flat_tensors(trees["G_ema"])
    held = ckpt.tree_to_flat_tensors(trainer.g_params)
    same = all(torch.equal(held[k], t) for k, t in loaded.items())
    latents = trainer.style_latents
    print(f"{config}: {os.path.basename(npz)} max|offset| {moved:.6f}; G "
          f"bit-equal to the snapshot {same}; style latents "
          f"{tuple(latents.shape)}")
    if not (moved > 0 and same and sorted(held) == sorted(loaded)
            and tuple(latents.shape) == (1, g_cfg.num_ws, g_cfg.w_dim)
            and bool(torch.isfinite(latents).all())
            and os.path.exists(os.path.join(out, "config.yaml"))):
        raise AssertionError(f"{config}: the run's outputs are wrong")
    return launches


def im2im_grads_check(params, card):
    """Pallas vs composed (TF32 off, CLIP fp32), on the same weights and
    draws.  The offsets' gradient of one DiFa step (offsets 0.2 * N(0, 1)),
    twice, each bound 2^-3 relative L2, as the adapt phase argues (the CLIP
    edit between the halves multiplies the level's rounding):
      - at step 0 with the phase's bf16 G, where the SCC term weighs 0;
      - at the trainer's last step (iter_num), where SCC weighs its full
        6.0, so e4e's forward and backward through both halves' images are
        in the gradient, with G's levels in fp32 (num_fp16_res 0: the fused
        level's fp32 route).  entry.im2im_entry rescales the random e4e's
        convolutions, so its latents stay O(1).  SCC's L1 keeps the 60% of
        channels with the smallest |trg - src| and takes their signs, which
        the two routes' bf16 rounding (2^-5 of an image) flips: 0.2286 at
        bf16 (H100 run, this check's first form); in fp32 the routes agree
        to ~1e-6 and the signs with them.
    Then one projector step without the
    noise penalty (which does not pass through G): the latent's gradient,
    bound 2^-4 as the fewshot phase's; and the noise buffers' gradients
    against the same step of an fp32 G (no bf16 levels, composed path).
    Those are sums over channels of terms that cancel, so a bf16 G leaves
    them tens of percent from the fp32 one on either path; the fused path
    must stay within 1.25 times the composed path's distance, over all
    buffers and at each fused level (a wrong d(noise) errs by O(100%))."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grads, scc_grads, proj = {}, {}, {}
    for label, pallas in (("pallas", True), ("composed", False)):
        trainer = im2im_entry(DEVICE, batch=IM2IM_BATCH, pallas_level=pallas,
                              clip_dtype="float32", g_params=params)
        gen = torch.Generator().manual_seed(5)
        for t in leaves_of([trainer.offsets]):
            t.copy_(0.2 * torch.randn(t.shape, generator=gen))
        for at, fp32, out in ((0, False, grads), (trainer.cfg.iter_num, True,
                                                  scc_grads)):
            if fp32:
                trainer.g_cfg = dataclasses.replace(
                    trainer.g_cfg, synthesis=dataclasses.replace(
                        trainer.g_cfg.synthesis, num_fp16_res=0))
            trainer.current_step = at
            fmc.fused_modconv3x3.launches = 0
            losses, out[label] = trainer.loss_and_grads(
                trainer.rng.fold_in(77))
            torch.cuda.synchronize()
            print(f"im2im gradient check, {label}, step {at} "
                  f"({'fp32' if fp32 else 'bf16'} G): DiFa losses "
                  + ", ".join(f"{k} {float(v):.6f}" for k, v in
                              losses.items())
                  + f", fused launches {fmc.fused_modconv3x3.launches}, on "
                  f"{card}")
        del trainer
        torch.cuda.empty_cache()
    lpips = detectors.make_default("vgg16_lpips", DEVICE)
    g_cfg = adapt_g_config()
    target = np.random.RandomState(43).randint(
        0, 256, (3,) + (g_cfg.img_resolution,) * 2, np.uint8)
    for label, pallas, fp16_res in (("pallas", True, None),
                                    ("composed", False, None),
                                    ("fp32", False, 0)):
        syn = dataclasses.replace(g_cfg.synthesis, pallas_level=pallas)
        if fp16_res is not None:
            syn = dataclasses.replace(syn, num_fp16_res=fp16_res)
        projector.project(
            dataclasses.replace(g_cfg, synthesis=syn), params, target,
            num_steps=1, w_avg_samples=1000, regularize_noise_weight=0.0,
            lpips_fn=lpips, rng=Rng(1),
            on_step=lambda step, dist, g: proj.__setitem__(label, g))
    a, b = grads["pallas"], grads["composed"]
    err = rel_l2(a, b, list(a))
    scc_err = rel_l2(scc_grads["pallas"], scc_grads["composed"],
                     list(scc_grads["pallas"]))
    level = {k: rel_l2(a, b, [k]) for k in a
             if k.startswith(("b128.conv1", "b256.conv1"))}
    lat = rel_l2(proj["pallas"], proj["composed"], ["latent"])
    noise = [k for k in proj["fp32"] if k != "latent"]
    to_fp32 = {}
    for keys in [noise] + [[f"noise.{n}"] for n in ("b128.conv1",
                                                    "b256.conv1")
                           if f"noise.{n}" in proj["fp32"]]:
        name = "all buffers" if len(keys) > 1 else keys[0]
        to_fp32[name] = tuple(rel_l2(proj[p], proj["fp32"], keys)
                              for p in ("pallas", "composed"))
    print(f"pallas vs composed (TF32 off, CLIP fp32): DiFa offset gradients "
          f"rel_l2 {err:.4g} at step 0, bf16 G, {scc_err:.4g} at SCC 6.0, "
          f"fp32 G (bound {2 ** -3:.4g} each)"
          + "".join(f", {k} {v:.4g}" for k, v in level.items())
          + f"; projector step: latent gradient rel_l2 {lat:.4g} (bound "
          f"{2 ** -4:.4g}); noise gradients' rel_l2 to the fp32 G, pallas / "
          f"composed: " + ", ".join(f"{k} {p:.4g} / {c:.4g}" for k, (p, c)
                                    in to_fp32.items())
          + f" (bound: pallas <= 1.25 x composed), on {card}")
    if not (err <= 2 ** -3 and scc_err <= 2 ** -3 and lat <= 2 ** -4 and all(
            p <= 1.25 * c for p, c in to_fp32.values())):
        raise AssertionError("im2im: pallas and composed gradients disagree")


def im2im_timing(params, card):
    """bench.py's DiFa step (entry.im2im_entry: batch 4, s_delta, ViT-B/32 +
    ViT-B/16, direction + difa_local + SCC 6.0 on e4e latents) with
    PyTorch's default math: one synced step, then IM2IM_BLOCKS blocks of 10
    steps, each ending in the one host read of its losses; the peak memory
    of those steps; one profiler trace of a step with the forward shares
    of e4e and of its backbone."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    trainer = im2im_entry(DEVICE, batch=IM2IM_BATCH, g_params=params)
    trainer.train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(IM2IM_BLOCKS):
        t0 = time.perf_counter()
        for _ in range(10):
            losses = trainer.train_step_async()
        host = {k: float(v) for k, v in losses.items()}
        rates.append(10 / (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(v) for v in host.values()) or \
            "difa_psp_loss" not in host:
        raise AssertionError(f"im2im timing: losses {host}")
    rate = float(np.mean(rates))
    res = trainer.g_cfg.img_resolution
    print(f"im2im_difa {res}^2 batch {IM2IM_BATCH}, ViT-B/32 + ViT-B/16, "
          f"direction + difa_local + SCC (e4e IR-SE-50, "
          f"{trainer._latent_cfg.style_count} heads): {rate:.4f} steps/s "
          f"(blocks of 10: {', '.join(f'{r:.4f}' for r in rates)}), peak "
          f"memory {peak / 2 ** 30:.3f} GiB, SCC window "
          f"{int(trainer.scc_state.count)} entries, on {card}", flush=True)
    trace_window(trainer.train_step_async, f"one DiFa step (batch "
                 f"{trainer.cfg.batch_size}, pallas_level=True)", card,
                 1e3 / rate, ranges=("e4e", "e4e_backbone"))
    return rate

# ----------------------------------------------------------------------------
# The ga phase: the GA direction search and the GA metrics


# Scan and batched evolutions from one key render the same samples, at
# batch 4 and at batch 128, where cuDNN and cuBLAS may pick other kernels
# and sum in another order.  The bf16 levels may then round an activation
# one ulp (2^-8 relative) apart, and a fitness score, a mean of cosines in
# [-1, 1], moves by about as much: 2^-8 absolute.  The directions come from
# the same draws through the same ops, so the best direction is equal
# (JAX's 1e-4) as long as both modes sort the scores alike.
GA_SCORE_TOL = 2 ** -8


def ga_phase(tmp, card):
    """evolve_directions of entry.ga_entry at FFHQ-1024 (Swin-T fitness on
    the raw 1024^2 images, 32 candidates of 4 images, elite 4) in scan and
    batched mode from one key: agreement, candidates/s, peak memory, fused
    launches and no backward; pallas vs composed scores of one batched
    generation; a trace of one; calculate_metrics of the best direction's
    images against the loop's PNGs.  TF32 off throughout (the Swin linear
    layers are fp32 matmuls either way).  Returns the fused launches by
    mode and the batched run (best, history, candidates/s, the first
    population, a z and its scores), which the dist phase repeats over two
    ranks."""
    phase("ga")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g_cfg = adapt_g_config()
    params = seeded_weights(sg2.init_generator(
        g_cfg, torch.Generator().manual_seed(0), DEVICE))
    dim = ga_search.direction_dim(g_cfg.synthesis)
    runs, launches = {}, {}
    for mode in ("scan", "batched"):
        torch.cuda.empty_cache()
        e = ga_entry(DEVICE, eval_mode=mode, generations=GA_GENERATIONS,
                     g_params=params)
        cfg = e.cfg
        # Warm-up at the run's shapes: the final scoring pass alone.
        ga_search.evolve_directions(Rng(GA_SEED), e.g_cfg, params,
                                    e.fitness_fn,
                                    dataclasses.replace(cfg, generations=0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fmc.fused_modconv3x3.launches = 0
        with BackwardNeeds() as needs:
            t0 = time.perf_counter()
            best, hist = ga_search.evolve_directions(
                Rng(GA_SEED), e.g_cfg, params, e.fitness_fn, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches[mode] = fmc.fused_modconv3x3.launches
        evals = cfg.generations + 1
        b = cfg.batch_per_candidate
        per_call = b if mode == "scan" else cfg.population * b
        calls = cfg.population * evals if mode == "scan" else evals
        want = expected_launches(g_cfg, per_call) * calls
        runs[mode] = (best, hist, cfg.population * evals / wall, wall / evals)
        print(f"ga {mode}: {cfg.population} candidates x {b} images at "
              f"{g_cfg.img_resolution}^2, {cfg.generations} generations + "
              f"the final scoring: {wall:.3f} s, "
              f"{runs[mode][2]:.3f} candidates/s, peak memory "
              f"{peak / 2 ** 30:.3f} GiB; history {hist.tolist()}; "
              f"fused_modconv3x3 launches {launches[mode]} (expected {want}: "
              f"{calls} G calls at batch {per_call}); backward calls "
              f"{len(needs.calls)}, on {card}", flush=True)
        if (launches[mode] != want or needs.calls or best.shape != (dim,)
                or not np.isfinite(hist).all() or not np.isfinite(best).all()
                or hist.shape != (cfg.generations,)):
            raise AssertionError(f"ga {mode}: the search failed")
    (best_s, hist_s, rate_s, _), (best_b, hist_b, rate_b, gen_s) = (
        runs["scan"], runs["batched"])
    hist_err = float(np.abs(hist_b - hist_s).max())
    best_err = float(np.abs(best_b - best_s).max())
    print(f"ga batched vs scan: history max|diff| {hist_err:.4g} (bound "
          f"{GA_SCORE_TOL:.4g}), best direction max|diff| {best_err:.4g} "
          f"(bound 1e-4); batched/scan {rate_b / rate_s:.3f}x "
          f"({rate_b:.3f} / {rate_s:.3f} candidates/s), on {card}",
          flush=True)
    if not (hist_err <= GA_SCORE_TOL and best_err <= 1e-4):
        raise AssertionError("ga: scan and batched evolutions disagree")
    population, z, scores = ga_pallas_check(e, params, card)
    torch.cuda.empty_cache()

    def generation():
        with torch.no_grad():
            ga_search.eval_batched(e.cfg, e.g_cfg, params, e.fitness_fn,
                                   population, z)

    trace_window(generation, f"one batched GA generation ({e.cfg.population} "
                 f"candidates x {e.cfg.batch_per_candidate} images at "
                 f"{g_cfg.img_resolution}^2, Swin-T fitness)", card,
                 1e3 * gen_s, ranges=("ga_render", "ga_fitness"))
    torch.cuda.empty_cache()
    ga_metrics_check(tmp, e, params, best_b, card)
    return launches, dict(best=best_b, history=hist_b, population=population,
                          z=z, scores=scores, rate=rate_b)


def ga_pallas_check(e, params, card):
    """One batched generation's images and scores, pallas vs composed G
    (TF32 off), on the search's first population and a fixed z.  Images:
    main_phase's bound (2^-5 relative RMS).  Scores: a score is a mean of
    cosines of pooled features; an image error of relative RMS r moves a
    feature vector by about r of its norm through a tower of gain near 1,
    and a cosine by at most twice that: 2 x 2^-5 = 2^-4 absolute.  A wrong
    kernel errs by O(1) in both.  Returns (population, z, the fused G's
    scores)."""
    cfg = e.cfg
    dim = ga_search.direction_dim(e.g_cfg.synthesis)
    pop, b = cfg.population, cfg.batch_per_candidate
    population = Rng(GA_SEED).split(2)[1].normal((pop, dim), DEVICE) \
        * cfg.init_sigma
    z = Rng(GA_SEED + 1).normal((b, e.g_cfg.z_dim), DEVICE)
    plain = dataclasses.replace(e.g_cfg, synthesis=dataclasses.replace(
        e.g_cfg.synthesis, pallas_level=False))
    imgs, scores = {}, {}
    with torch.no_grad():
        for label, g in (("pallas", e.g_cfg), ("composed", plain)):
            hooks = ga_search.batched_direction_hooks(
                g.synthesis, population.repeat_interleave(b, dim=0))
            img = ga_search.render(g, params, z.repeat(pop, 1),
                                   cfg.truncation_psi, hooks)
            scores[label] = torch.func.vmap(e.fitness_fn)(
                img.reshape((pop, b) + img.shape[1:]))
            imgs[label] = img / 127.5 - 1
        diff = imgs["pallas"] - imgs["composed"]
        rel_rms = float(diff.square().mean().sqrt()
                        / imgs["composed"].square().mean().sqrt())
        del imgs, diff
    sp, sc = scores["pallas"].cpu().numpy(), scores["composed"].cpu().numpy()
    err = float(np.abs(sp - sc).max())
    gaps = np.diff(np.sort(sc))
    print(f"ga pallas vs composed (batch {pop * b}, TF32 off): images "
          f"rel_rms {rel_rms:.4g} (bound {2 ** -5:.4g}); scores max|diff| "
          f"{err:.4g} (bound {2 ** -4:.4g}); the composed scores span "
          f"{float(sc.max() - sc.min()):.4g}, nearest two "
          f"{float(gaps.min()):.4g} apart, on {card}", flush=True)
    if not (rel_rms <= 2 ** -5 and err <= 2 ** -4
            and np.isfinite(sp).all()):
        raise AssertionError("ga: pallas and composed scores disagree")
    return population, z, sp


def ga_metrics_check(tmp, e, params, best, card):
    """calculate_metrics of GA_EVAL_IMAGES renders of the best direction
    (uint8, truncation 0.7) against as many of the loop's 1024^2 PNGs:
    Swin-T features (the fitness tower) for FID and KID, the pairwise
    alex-LPIPS (random weights of the real shape).  FID of 32 samples of
    768-d features is rank-deficient: printed with sqrtm's warning, not
    checked."""
    data = os.path.join(tmp, "data")
    names = sorted(os.listdir(data))[:GA_EVAL_IMAGES]
    real = torch.from_numpy(np.stack([
        png.read_png(os.path.join(data, n)).transpose(2, 0, 1)
        for n in names])).to(DEVICE)
    z = torch.from_numpy(np.random.RandomState(7).randn(
        len(names), e.g_cfg.z_dim).astype(np.float32)).to(DEVICE)
    with torch.no_grad():
        gen = ga_search.render(e.g_cfg, params, z, e.cfg.truncation_psi,
                               ga_search.direction_to_hooks(
                                   e.g_cfg.synthesis,
                                   torch.from_numpy(best).to(DEVICE)))
    gen = gen.to(torch.uint8)
    lpips = ga_eval.make_alex_lpips(device=DEVICE)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fid, kid, lp = ga_eval.calculate_metrics(
            real, gen, lambda u8: e.extract(u8.float() / 127.5 - 1.0),
            lpips_pair_fn=lpips)
    wall = time.perf_counter() - t0
    said = sorted({f"{w.category.__name__}: {w.message}" for w in caught
                   if not issubclass(w.category, DeprecationWarning)})
    print(f"ga calculate_metrics ({len(names)} loop PNGs vs {len(names)} "
          f"images of the best direction, {real.shape[-1]}^2, Swin-T "
          f"features, alex-LPIPS pairs): FID {fid:.6g}, KID {kid:.6g}, "
          f"LPIPS {lp:.6g} in {wall:.3f} s; sqrtm warned: "
          f"{said or 'no'}, on {card}", flush=True)
    if not (np.isfinite(kid) and np.isfinite(lp) and lp > 0):
        raise AssertionError("ga: calculate_metrics gave non-finite KID or "
                             "LPIPS")


# ----------------------------------------------------------------------------
# The metrics phase: snapshot metrics


class DtypeRecorder:
    """Records the activation dtype of each launch of the fused level."""

    def __init__(self):
        self.dtypes = []
        self._fwd = None

    def __enter__(self):
        self._fwd = fmc._forward

        def recording(x, *args):
            self.dtypes.append(x.dtype)
            return self._fwd(x, *args)

        fmc._forward = recording
        return self

    def __exit__(self, *exc):
        fmc._forward = self._fwd


def metrics_phase(tmp, snap, card):
    """cli/calc_metrics.py on the loop's snapshot and PNGs (METRICS, twice),
    then the compute functions of pr50k3, is50k and ppl2_wend at
    METRICS_SAMPLES samples, Inception features pallas vs composed, and the
    generator-stats rate.  Returns (fused launches, PPL's fp32 launches)."""
    phase("metrics")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    launches = metrics_cli_runs(tmp, snap, card)
    g_cfg, params = generate.load_generator(snap, DEVICE)
    dataset = ImageFolderDataset(os.path.join(tmp, "data"))

    def opts():
        return fs.MetricOptions(g_params=params, g_cfg=g_cfg, dataset=dataset,
                                batch_size=METRICS_BATCH, device=DEVICE)

    batches = -(-METRICS_SAMPLES // METRICS_BATCH)
    per = expected_launches(g_cfg, METRICS_BATCH) * batches
    results, counts = {}, {}
    for name, fn in (
            ("pr50k3", lambda: pr_lib.compute_pr(
                opts(), max_real=50000, num_gen=METRICS_SAMPLES)),
            ("is50k", lambda: is_lib.compute_is(
                opts(), num_gen=METRICS_SAMPLES, num_splits=10)),
            ("ppl2_wend", lambda: ppl_lib.compute_ppl(
                opts(), num_samples=METRICS_SAMPLES, epsilon=1e-4, space="w",
                sampling="end", crop=False))):
        fmc.fused_modconv3x3.launches = 0
        t0 = time.perf_counter()
        with DtypeRecorder() as rec:
            results[name] = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = fmc.fused_modconv3x3.launches
        dtypes = sorted({str(d)[6:] for d in rec.dtypes})
        print(f"{name} compute at {METRICS_SAMPLES} samples (batch "
              f"{METRICS_BATCH}): {results[name]} in {wall:.3f} s; "
              f"fused_modconv3x3 launches {counts[name]} (expected {per}) in "
              f"{dtypes}, on {card}", flush=True)
        want_dtype = ([] if per == 0 else ["float32"] if name == "ppl2_wend"
                      else ["bfloat16"])
        if (counts[name] != per or dtypes != want_dtype
                or not np.isfinite(results[name]).all()):
            raise AssertionError(f"{name}: the metric failed")
    torch.cuda.empty_cache()
    ppl_pallas_check(opts, card)
    torch.cuda.empty_cache()
    inception_pallas_check(g_cfg, params, card)
    torch.cuda.empty_cache()
    generator_stats_rate(opts(), card)
    return launches + sum(counts.values()), counts["ppl2_wend"]


def metrics_cli_runs(tmp, snap, card):
    """The command twice with one cache directory: finite results, the
    random-detector warning, one more line in each metric-<name>.jsonl a
    run; the second run reads both dataset statistics from the cache, equal
    bit for bit to the first run's.  Returns the fused launches."""
    cache = os.path.join(tmp, "metrics-cache")
    argv = ["--network", snap, "--metrics", ",".join(METRICS), "--data",
            os.path.join(tmp, "data"), "--cache-dir", cache, "--batch",
            str(METRICS_BATCH), "--device", DEVICE]
    g_cfg, _ = generate.load_generator(snap, "cpu")
    per_metric = (expected_launches(g_cfg, METRICS_BATCH)
                  * -(-1000 // METRICS_BATCH))
    real_side, loads, launches = [], [], 0
    orig_stats, orig_load = fs.compute_feature_stats_for_dataset, \
        fs.FeatureStats.load

    def recording_stats(*a, **k):
        real_side[-1].append(orig_stats(*a, **k))
        return real_side[-1][-1]

    def recording_load(path):
        loads[-1].append(path)
        return orig_load(path)

    fs.compute_feature_stats_for_dataset = recording_stats
    fs.FeatureStats.load = staticmethod(recording_load)
    try:
        for run in (1, 2):
            real_side.append([])
            loads.append([])
            err = io.StringIO()
            fmc.fused_modconv3x3.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                results = calc_metrics_cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = fmc.fused_modconv3x3.launches
            launches += n
            sys.stderr.write(err.getvalue())
            values = {k: v for r in results for k, v in r["results"].items()}
            cached = sorted(os.listdir(cache))
            warned = calc_metrics_cli.RANDOM_DETECTOR_WARNING in err.getvalue()
            print(f"calc_metrics run {run}: {values} in {wall:.3f} s "
                  f"(batch {METRICS_BATCH}); fused_modconv3x3 launches {n} "
                  f"(expected {per_metric * len(METRICS)}); dataset "
                  f"statistics read from the cache: {len(loads[-1])}; cache "
                  f"files {cached}; random-detector warning {warned}, on "
                  f"{card}", flush=True)
            if (n != per_metric * len(METRICS)
                    or sorted(values) != sorted(METRICS)
                    or not all(np.isfinite(v) for v in values.values())
                    or not warned or len(cached) != len(METRICS)
                    or len(loads[-1]) != (0 if run == 1 else len(METRICS))):
                raise AssertionError(f"calc_metrics run {run} failed")
    finally:
        fs.compute_feature_stats_for_dataset = orig_stats
        fs.FeatureStats.load = staticmethod(orig_load)
    for first, second in zip(*real_side):
        same = first.num_items == second.num_items
        if first.capture_mean_cov:
            same = same and np.array_equal(first.raw_mean, second.raw_mean) \
                and np.array_equal(first.raw_cov, second.raw_cov)
        if first.capture_all:
            same = same and np.array_equal(first.get_all(), second.get_all())
        if not same:
            raise AssertionError("calc_metrics: the cached dataset "
                                 "statistics differ from the computed ones")
    for m in METRICS:
        with open(os.path.join(os.path.dirname(snap),
                               f"metric-{m}.jsonl")) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        if len(lines) != 2 or not all(np.isfinite(ln["results"][m])
                                      for ln in lines):
            raise AssertionError(f"metric-{m}.jsonl: {lines}")
    print(f"calc_metrics: the second run's dataset statistics are the "
          f"first run's, bit for bit; metric-{{{','.join(METRICS)}}}.jsonl "
          f"hold 2 lines each")
    return launches


def ppl_pallas_check(opts, card):
    """ppl2_wend's per-sample distances at PPL_CHECK_SAMPLES samples, twice
    on the same seeds and noise: the fused levels' fp32 route (the kernel)
    and the composed fp32 path (cuDNN), TF32 off.

    The tolerance, from the worst case: a render of the two differs by
    summation order and the place of the modulation's rounding only, about
    1e-6 of the image (the kernels phase holds a level to 1e-4 of max|y|
    and finds far less).  A distance is |f(t + eps) - f(t)|^2 / eps^2 with
    eps = 1e-4; over t in [0, 1] the path between two independent latents
    changes the image by about all of itself, so the eps-difference is
    about 1e-4 of the image.  Were the two ends' rounding errors
    independent, a 1e-6 error would move the difference by ~1e-2 relative
    and the squared distance by ~2e-2, more where a sample's path is
    locally flat.  (The ends go through the same code 1e-4 apart, so their
    errors mostly cancel and the run shows far less; the bound does not
    count on it.)  The mean is the distance-weighted average of the
    per-sample relative differences, whatever their signs, so flat samples
    weigh little in it: bound 2^-4 relative on the means (PPL's trimmed
    mean; at 64 samples its 1st and 99th percentiles are the minimum and
    the maximum), three times 2e-2 for the layers downstream of the two
    levels.  The per-sample maximum is printed, not bound.  A wrong kernel
    changes the images by O(1), and the distances with them."""
    torch.backends.cudnn.allow_tf32 = False
    g_cfg = opts().g_cfg
    plain = dataclasses.replace(g_cfg, synthesis=dataclasses.replace(
        g_cfg.synthesis, pallas_level=False))
    dist, dets = {}, {}
    for label, g in (("pallas", g_cfg), ("composed", plain)):
        o = opts()
        o.g_cfg, o.detectors = g, dets          # one LPIPS tower for both
        fmc.fused_modconv3x3.launches = 0
        dist[label] = ppl_lib.path_distances(
            o, num_samples=PPL_CHECK_SAMPLES, epsilon=1e-4, space="w",
            sampling="end", crop=False)
        if label == "composed" and fmc.fused_modconv3x3.launches:
            raise AssertionError("ppl: the composed path launched the kernel")
    torch.backends.cudnn.allow_tf32 = True
    a, b = dist["pallas"], dist["composed"]
    rel = np.abs(a - b) / np.abs(b)
    means = [ppl_lib.trimmed_mean(d) for d in (a, b)]
    mean_rel = abs(means[0] - means[1]) / abs(means[1])
    print(f"ppl2_wend pallas vs composed (fp32 G, TF32 off) at "
          f"{PPL_CHECK_SAMPLES} samples: per-sample relative difference "
          f"median {float(np.median(rel)):.4g} max {float(rel.max()):.4g}; "
          f"means {means[0]:.8g} / {means[1]:.8g}, relative {mean_rel:.4g} "
          f"(bound {2 ** -4:.4g}), on {card}", flush=True)
    if not (np.isfinite(a).all() and np.isfinite(b).all()
            and mean_rel <= 2 ** -4):
        raise AssertionError("ppl: pallas and composed distances disagree")


def inception_pallas_check(g_cfg, params, card):
    """Inception features of 32 generated images (random noise from one
    key), pallas vs composed G (TF32 off).  The images agree within
    main_phase's 2^-5 relative RMS; the features are spatial means of ReLU
    maps of a tower of gain near 1, so about as close: bound 2^-4 relative
    L2 (twice the images'), against O(1) for a wrong kernel."""
    torch.backends.cudnn.allow_tf32 = False
    det = detectors.make_default("inception", DEVICE)
    plain = dataclasses.replace(g_cfg, synthesis=dataclasses.replace(
        g_cfg.synthesis, pallas_level=False))
    z = Rng(11).normal((METRICS_BATCH, g_cfg.z_dim), DEVICE)
    feats = {}
    with torch.no_grad():
        for label, g in (("pallas", g_cfg), ("composed", plain)):
            img = sg2.generator_apply(g, params, z, noise_mode="random",
                                      generator=Rng(12))
            feats[label] = det(fs.to_uint8(img)).float()
    a, b = feats["pallas"], feats["composed"]
    err = float((a - b).norm() / b.norm())
    torch.backends.cudnn.allow_tf32 = True
    print(f"metrics pallas vs composed: Inception features of "
          f"{METRICS_BATCH} images rel_l2 {err:.4g} (bound {2 ** -4:.4g}), "
          f"on {card}", flush=True)
    if not err <= 2 ** -4:
        raise AssertionError("metrics: pallas and composed features disagree")


def generator_stats_rate(opts, card):
    """compute_feature_stats_for_generator (G with random noise, the uint8
    clip, the 1024 -> 299 resize and Inception, the host's float64
    mean/cov) for METRICS_SAMPLES samples at batch METRICS_BATCH, after one
    warm-up batch: images/s and peak memory."""
    fs.compute_feature_stats_for_generator(opts, "inception",
                                           capture_mean_cov=True,
                                           max_items=METRICS_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = fs.compute_feature_stats_for_generator(
        opts, "inception", capture_mean_cov=True, max_items=METRICS_SAMPLES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"generator stats (G + resize + Inception) at batch "
          f"{METRICS_BATCH}: {stats.num_items / wall:.3f} images/s "
          f"({stats.num_items} in {wall:.3f} s), peak memory "
          f"{peak / 2 ** 30:.3f} GiB, on {card}", flush=True)
    if stats.num_items != METRICS_SAMPLES or not np.isfinite(
            stats.get_mean_cov()[1]).all():
        raise AssertionError("generator stats failed")


# ----------------------------------------------------------------------------
# The inversion phase: image -> W+ (ReStyle, II2S) -> edits -> Inferencer


# The inversion phase: project_restyle (RESTYLE_ITERS iterations) for each
# encoder type at batch 1, run_on_batch timed at RESTYLE_BATCH over
# RESTYLE_TIMED calls; II2S_STEPS of II2S's 1300 steps with a PCA of
# II2S_PCA mapped samples; D_STEPS Adam steps of e4e's latent D through a
# pool of POOL_SIZE codes.
RESTYLE_ITERS, RESTYLE_BATCH, RESTYLE_TIMED = 5, 4, 3
II2S_STEPS, II2S_PCA = 20, 100_000
POOL_SIZE, D_STEPS = 50, 3
# (dx, dW, dstyles, ddcoefs, dnoise, dbias) of an II2S step: the W+ latents
# take gradients, G's weights and noise buffers do not.
II2S_NEEDS = (True, False, True, True, False, False)
# Two channel edits on the fused levels (b128.conv1, b256.conv1 of
# FFHQ-1024: layers 15 and 18), offset factors 0.5 and 0.
STYLE_EDITS = [((15, 3), 3.0, 0.5), ((18, 2), -2.0, 0.0)]


def inversion_g_config():
    """The generator of the inversion phase: entry_config() (FFHQ-1024,
    pallas_level=True)."""
    return entry_config()


def restyle_net(encoder_type, batch, params, pallas_level=True):
    """entry.restyle_entry on the phase's generator weights."""
    g_cfg = inversion_g_config()
    return restyle_entry(DEVICE, encoder_type, batch=batch,
                         pallas_level=pallas_level,
                         tiny=g_cfg.img_resolution != 1024, g_params=params)


class RunRecorder:
    """Records the per-iteration lists of every run_on_batch call."""

    def __init__(self):
        self.runs = []
        self._fn = None

    def __enter__(self):
        self._fn = restyle_lib.run_on_batch

        def recording(*a, **k):
            self.runs.append(self._fn(*a, **k))
            return self.runs[-1]

        restyle_lib.run_on_batch = recording
        return self

    def __exit__(self, *exc):
        restyle_lib.run_on_batch = self._fn


def inversion_phase(tmp, card):
    """ReStyle (all six encoder types through inference.project_restyle,
    the default one timed and held against the composed level per
    iteration), the restyle converter, the Inferencer's three model types,
    II2S, the three editors and e4e's latent adversary, on one 1024^2 PNG
    rendered by the Forward G.  Returns (fused launches, the II2S
    backward's flags)."""
    phase("inversion")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    g_cfg = inversion_g_config()
    params = seeded_weights(sg2.init_generator(
        g_cfg, torch.Generator().manual_seed(0), DEVICE))
    res = g_cfg.img_resolution
    target = os.path.join(tmp, "inversion_target.png")
    z = torch.from_numpy(np.random.RandomState(44).randn(
        1, g_cfg.z_dim).astype(np.float32)).to(DEVICE)
    with torch.no_grad():
        png.write_png(target, generate.to_uint8(sg2.generator_apply(
            g_cfg, params, z, noise_mode="const"))[0])
    image = read_rgb(target)
    if image.shape != (res, res, 3):
        raise AssertionError(f"target PNG read back as {image.shape}")
    launches, ws = restyle_runs(image, params, card)
    torch.cuda.empty_cache()
    launches += restyle_convert_run(tmp, image, card)
    torch.cuda.empty_cache()
    launches += inferencer_runs(tmp, params, ws, card)
    torch.cuda.empty_cache()
    n, needs = ii2s_run(image, params, card)
    launches += n
    torch.cuda.empty_cache()
    launches += edit_runs(params, ws, card)
    latent_d_round(params, card)
    return launches, needs


def restyle_runs(image, params, card):
    """project_restyle for each encoder type at batch 1; run_on_batch of
    the default type timed at RESTYLE_BATCH; pallas vs composed per
    iteration.  Returns (fused launches, the default type's W+ [1, L,
    512])."""
    g_cfg = inversion_g_config()
    per = expected_launches(g_cfg, 1) * (RESTYLE_ITERS + 1)
    launches, ws = 0, None
    for encoder_type in restyle_lib.ENCODER_TYPES:
        net, _ = restyle_net(encoder_type, 1, params)
        fmc.fused_modconv3x3.launches = 0
        t0 = time.perf_counter()
        with BackwardNeeds() as needs, RunRecorder() as rec:
            img, w = inference.project_restyle(image, net,
                                               n_iters=RESTYLE_ITERS)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = fmc.fused_modconv3x3.launches
        launches += n
        (images, latents), = rec.runs
        finite = all(bool(torch.isfinite(t).all()) for t in images + latents)
        print(f"project_restyle {encoder_type}: {RESTYLE_ITERS} iterations "
              f"at batch 1 in {wall:.3f} s; images {tuple(img.shape)}, W+ "
              f"{tuple(w.shape)}, max|W+ - latent_avg| per iteration "
              + ", ".join(f"{float((t - net.latent_avg).abs().max()):.4g}"
                          for t in latents)
              + f"; every iteration finite {finite}; fused_modconv3x3 "
              f"launches {n} (expected {per}), backward calls "
              f"{len(needs.calls)}, on {card}", flush=True)
        if (tuple(img.shape) != (1, 3, g_cfg.img_resolution,
                                 g_cfg.img_resolution)
                or tuple(w.shape) != (1, g_cfg.num_ws, 512) or not finite
                or len(images) != RESTYLE_ITERS or n != per or needs.calls):
            raise AssertionError(f"project_restyle {encoder_type} failed")
        if encoder_type == restyle_lib.RestyleEncoderConfig.encoder_type:
            ws = w
        del net, images, latents
        torch.cuda.empty_cache()
    restyle_timing(params, card)
    restyle_pallas_check(params, card)
    return launches, ws


def restyle_timing(params, card):
    """run_on_batch of the default type at RESTYLE_BATCH: one warm-up call,
    then RESTYLE_TIMED calls, each ending in a synchronize; images/s, peak
    memory and a trace of one call (IR-SE-50's share)."""
    net, inputs = restyle_net(restyle_lib.RestyleEncoderConfig.encoder_type,
                              RESTYLE_BATCH, params)
    restyle_lib.run_on_batch(net, inputs, n_iters=RESTYLE_ITERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(RESTYLE_TIMED):
        t0 = time.perf_counter()
        restyle_lib.run_on_batch(net, inputs, n_iters=RESTYLE_ITERS)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    rate = RESTYLE_BATCH / float(np.mean(secs))
    print(f"run_on_batch {net.enc_cfg.encoder_type} at batch "
          f"{RESTYLE_BATCH}, {RESTYLE_ITERS} iterations: {rate:.4f} "
          f"images/s (calls {', '.join(f'{s:.4f}' for s in secs)} s), peak "
          f"memory {peak / 2 ** 30:.3f} GiB, on {card}", flush=True)
    trace_window(lambda: restyle_lib.run_on_batch(net, inputs,
                                                  n_iters=RESTYLE_ITERS),
                 f"one run_on_batch ({RESTYLE_ITERS} iterations, batch "
                 f"{RESTYLE_BATCH}, pallas_level=True)", card,
                 1e3 * float(np.mean(secs)), ranges=("e4e_backbone",))


# The iterations of restyle_pallas_check held to 2^(k - 5): all of them.
RESTYLE_HELD_ITERS = 5


def restyle_pallas_check(params, card):
    """run_on_batch of the default type at RESTYLE_BATCH with the fused and
    the composed level (TF32 off), per iteration k: the relative RMS gap of
    the pooled images and of the codes' change from latent_avg.  The two
    level routes round differently, at most 2^-5 relative RMS in an image
    (main_phase's bound), and each iteration feeds its decode back into the
    encoder: with a loop that at most doubles what it is fed, iteration k
    is within 2^(k - 5).  entry.restyle_entry scales the random heads by
    RESTYLE_HEAD_SCALE so that the loop contracts (unscaled, the codes grew
    2.2-4x an iteration), and every iteration is held to its bound; the
    codes' growth is printed beside it.  A wrong kernel misses by O(1) at
    iteration 0."""
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for label, pallas in (("pallas", True), ("composed", False)):
        net, inputs = restyle_net(
            restyle_lib.RestyleEncoderConfig.encoder_type, RESTYLE_BATCH,
            params, pallas_level=pallas)
        images, latents = restyle_lib.run_on_batch(net, inputs,
                                                   n_iters=RESTYLE_ITERS)
        out[label] = ([restyle_lib.adaptive_avg_pool(i) for i in images],
                      [t - net.latent_avg for t in latents])
        del net
    torch.backends.cudnn.allow_tf32 = True

    def rms(a):
        return float(a.square().mean().sqrt())

    deltas = out["composed"][1]
    growth = [1.0] + [rms(b) / rms(a) for a, b in zip(deltas, deltas[1:])]
    gaps = [(rms(pi - ci) / rms(ci), rms(pl - cl) / rms(cl))
            for pi, pl, ci, cl in zip(*out["pallas"], *out["composed"])]
    print("restyle pallas vs composed per iteration (TF32 off), pooled "
          "image / codes rel_rms (the codes' growth): " + "; ".join(
              f"{k}: {a:.4g} / {b:.4g} ({growth[k]:.3g}x)"
              + (f" bound {2.0 ** (k - 5):.4g}" if k < RESTYLE_HELD_ITERS
                 else "") for k, (a, b) in enumerate(gaps))
          + f", on {card}", flush=True)
    if not all((a <= 2.0 ** (k - 5) and b <= 2.0 ** (k - 5))
               if k < RESTYLE_HELD_ITERS else (a < 1 and b < 1)
               for k, (a, b) in enumerate(gaps)):
        raise AssertionError("restyle: pallas and composed iterations "
                             "disagree")


def rosinality_state_dict(flat):
    """The rosinality Generator state dict whose conversion
    (convert_weights.rosinality_to_flat) gives the flat G ``flat`` back
    (w_avg aside)."""
    sd = {"input.input": flat["synthesis.b4.const"][None]}
    n_mlp = sum(k.startswith("mapping.fc") and k.endswith(".weight")
                for k in flat)
    for i in range(n_mlp):
        sd[f"style.{i + 1}.weight"] = flat[f"mapping.fc{i}.weight"]
        sd[f"style.{i + 1}.bias"] = flat[f"mapping.fc{i}.bias"]

    def conv(dst, src, noise_key):
        sd[f"{dst}.conv.weight"] = flat[f"{src}.weight"][None]
        sd[f"{dst}.conv.modulation.weight"] = flat[f"{src}.affine.weight"]
        sd[f"{dst}.conv.modulation.bias"] = flat[f"{src}.affine.bias"]
        sd[f"{dst}.noise.weight"] = flat[f"{src}.noise_strength"].reshape(1)
        sd[f"{dst}.activate.bias"] = flat[f"{src}.bias"]
        sd[noise_key] = flat[f"{src}.noise_const"][None, None]

    def rgb(dst, src):
        sd[f"{dst}.conv.weight"] = flat[f"{src}.weight"][None]
        sd[f"{dst}.conv.modulation.weight"] = flat[f"{src}.affine.weight"]
        sd[f"{dst}.conv.modulation.bias"] = flat[f"{src}.affine.bias"]
        sd[f"{dst}.bias"] = flat[f"{src}.bias"].reshape(1, -1, 1, 1)

    conv("conv1", "synthesis.b4.conv1", "noises.noise_0")
    rgb("to_rgb1", "synthesis.b4.torgb")
    res = 8
    while f"synthesis.b{res}.conv0.weight" in flat:
        b = int(np.log2(res)) - 3
        conv(f"convs.{2 * b}", f"synthesis.b{res}.conv0",
             f"noises.noise_{2 * b + 1}")
        conv(f"convs.{2 * b + 1}", f"synthesis.b{res}.conv1",
             f"noises.noise_{2 * b + 2}")
        rgb(f"to_rgbs.{b}", f"synthesis.b{res}.torgb")
        res *= 2
    return sd


def restyle_convert_run(tmp, image, card):
    """A seeded ReStyle checkpoint in the reference's torch layout (the
    default encoder type with BN num_batches_tracked, a rosinality decoder
    of the config-f generator, opts, a [512] latent_avg), torch.save'd;
    convert_weights restyle on it; load_net's leaves against the dict, bit
    for bit; project_restyle on the npz, whose G is JAX's fp32 config with
    the fused level off: no launch.  Returns the fused launches (0)."""
    g_cfg = inversion_g_config()
    res = g_cfg.img_resolution
    rcfg = sg2.GeneratorConfig(
        img_resolution=res,
        mapping=sg2.MappingConfig(num_layers=8, lr_multiplier=0.01),
        synthesis=sg2.SynthesisConfig(channel_base=32768, channel_max=512))
    gen = torch.Generator().manual_seed(21)
    dec = ckpt.tree_to_flat(sg2.init_generator(rcfg, gen, "cpu"))
    e_cfg = restyle_lib.RestyleEncoderConfig(stylegan_size=res)
    enc = ckpt.tree_to_flat(restyle_lib.init_restyle_encoder(gen, e_cfg))
    sd = {f"encoder.{k}": torch.from_numpy(v) for k, v in enc.items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(3)
    sd.update({f"decoder.{k}": torch.from_numpy(np.ascontiguousarray(v))
               for k, v in rosinality_state_dict(dec).items()})
    avg = torch.randn((512,), generator=gen)
    src, dest = os.path.join(tmp, "restyle.pt"), os.path.join(tmp,
                                                              "restyle.npz")
    torch.save({"state_dict": sd, "latent_avg": avg,
                "opts": {"encoder_type": e_cfg.encoder_type,
                         "output_size": res, "input_nc": 6}}, src)
    t0 = time.perf_counter()
    convert_weights.main(["restyle", "--src", src, "--dest", dest])
    convert_s = time.perf_counter() - t0
    net = restyle_lib.load_net(dest, DEVICE)
    got_enc = ckpt.tree_to_flat(net.enc_params)
    got_dec = ckpt.tree_to_flat(net.g_params)
    same = (sorted(got_enc) == sorted(enc) and all(
        np.array_equal(got_enc[k], v) for k, v in enc.items())
        and sorted(got_dec) == sorted(dec) and all(
            np.array_equal(got_dec[k], v) for k, v in dec.items()
            if k != "mapping.w_avg")
        and not got_dec["mapping.w_avg"].any()
        and np.array_equal(net.latent_avg.cpu().numpy(),
                           np.tile(avg.numpy()[None], (e_cfg.style_count, 1))))
    fmc.fused_modconv3x3.launches = 0
    t0 = time.perf_counter()
    img, w = inference.project_restyle(image, dest, n_iters=RESTYLE_ITERS,
                                       device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = fmc.fused_modconv3x3.launches
    print(f"restyle converter: {os.path.getsize(src) / 2 ** 20:.1f} MiB "
          f"checkpoint converted in {convert_s:.3f} s; load_net's leaves "
          f"bit-equal to the state dict {same} (w_avg zero, latent_avg "
          f"tiled); project_restyle on the npz (fp32 config-f G, fused "
          f"level off) in {wall:.3f} s with loading: W+ {tuple(w.shape)}, "
          f"fused_modconv3x3 launches {n} (expected 0), on {card}",
          flush=True)
    if not (same and n == 0 and bool(torch.isfinite(img).all())
            and net.g_cfg.synthesis.pallas_level is False):
        raise AssertionError("restyle converter failed")
    return n


def inferencer_runs(tmp, params, ws, card):
    """A snapshot of the Forward G and three adaptations: s_delta with zero
    offsets (target == source bit for bit), with seeded offsets (target
    differs), and ``original`` holding a second seeded G's synthesis
    (target == that G's render: the same code path, so within the level's
    2^-5, and in fact equal).  Returns the fused launches."""
    g_cfg = inversion_g_config()
    cfg_dict = {"g_cfg": config_lib.to_dict(g_cfg)}
    snap = os.path.join(tmp, "inversion_snapshot.npz")
    ckpt.save_snapshot(snap, g_ema=params, config=cfg_dict)
    spec = offs_lib.OffsetsSpec.from_string("s_delta")
    zero = offs_lib.init_offsets(Rng(0), g_cfg.synthesis, spec, DEVICE)
    gen = torch.Generator().manual_seed(23)
    seeded = sg2.tree_map(lambda t: (0.2 * torch.randn(
        t.shape, generator=gen)).to(DEVICE), zero)
    second = seeded_weights(sg2.init_generator(
        g_cfg, torch.Generator().manual_seed(24), DEVICE), seed=25)
    adapts = {"zero": ("parametrization", "s_delta", zero),
              "seeded": ("parametrization", "s_delta", seeded),
              "original": ("original", "", {"synthesis":
                                            second["synthesis"]})}
    launches = 0
    for label, (model_type, param, offsets) in adapts.items():
        path = os.path.join(tmp, f"inversion_{label}.npz")
        ckpt.save_adaptation(path, model_type=model_type,
                             parametrization=param, offsets=offsets,
                             sg2_config=cfg_dict)
        infer = inference.Inferencer(path, snap, device=DEVICE)
        fmc.fused_modconv3x3.launches = 0
        src, trg = infer.from_wplus(ws)
        torch.cuda.synchronize()
        n = fmc.fused_modconv3x3.launches
        launches += n
        diff = float((trg - src).abs().max())
        if label == "zero":
            ok = torch.equal(trg, src)
        elif label == "seeded":
            ok = diff > 0
        else:
            with torch.no_grad():
                want = sg2.synthesis_apply(g_cfg.synthesis,
                                           second["synthesis"], ws,
                                           noise_mode="const")
            gap = float((trg - want).square().mean().sqrt()
                        / want.square().mean().sqrt())
            ok = gap <= 2 ** -5
            label += (f" (rel_rms to the second G's plain render {gap:.4g}, "
                      f"bound {2 ** -5:.4g})")
        print(f"Inferencer {label}: from_wplus of the ReStyle W+, max|target "
              f"- source| {diff:.4g}; fused_modconv3x3 launches {n} "
              f"(expected {2 * expected_launches(g_cfg, 1)}), on {card}",
              flush=True)
        if not ok or n != 2 * expected_launches(g_cfg, 1):
            raise AssertionError(f"Inferencer {label} failed")
        del infer
    return launches


def ii2s_run(image, params, card):
    """invert_image for II2S_STEPS steps on the PNG with a random VGG16-LPIPS
    and a PCA of II2S_PCA samples (mapping on the card, SVD on the host,
    timed apart): s/step, peak memory, 2 fused launches a step, backward
    flags II2S_NEEDS only, a finite loss at the result; then one step's W+
    gradient, pallas vs composed (TF32 off), bound 2^-4 as the projector's
    latent gradient.  Returns (fused launches, backward flags)."""
    g_cfg = inversion_g_config()
    cfg = ii2s.II2SConfig(steps=II2S_STEPS, pca_samples=II2S_PCA)
    t0 = time.perf_counter()
    X = ii2s.mapped_samples(g_cfg, params, Rng(31), cfg.pca_samples)
    map_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pca = ii2s.pca_of(X)
    svd_s = time.perf_counter() - t0
    lpips = detectors.make_default("vgg16_lpips", DEVICE)
    target = image.transpose(2, 0, 1).astype(np.float32) / 127.5 - 1.0
    per = expected_launches(g_cfg, 1)
    fmc.fused_modconv3x3.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with BackwardNeeds() as needs:
        w = ii2s.invert_image(cfg, g_cfg, params, target, lpips_fn=lpips,
                              pca=pca, rng=Rng(31))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = fmc.fused_modconv3x3.launches
    ref = torch.from_numpy(target).to(DEVICE)[None]
    loss_fn = ii2s.make_loss(cfg, g_cfg, params, ref, lpips, pca)
    with torch.no_grad():
        loss, (l2, percep, pn) = loss_fn(torch.from_numpy(w).to(DEVICE)[None])
    flags = sorted(set(needs.calls))
    print(f"II2S: PCA of {cfg.pca_samples} mapped samples, mapping "
          f"{map_s:.3f} s on the card, SVD {svd_s:.3f} s on the host; "
          f"{II2S_STEPS} of {ii2s.II2SConfig().steps} steps at {g_cfg.img_resolution}^2 in {wall:.3f} s "
          f"({wall / II2S_STEPS:.4f} s/step), peak memory "
          f"{peak / 2 ** 30:.3f} GiB; loss at the result {float(loss):.6f} "
          f"(l2 {float(l2):.6f}, percep {float(percep):.6f}, p-norm "
          f"{float(pn):.6f}); fused_modconv3x3 launches {n} (expected "
          f"{per * II2S_STEPS}); backward (dx, dW, dstyles, ddcoefs, dnoise, "
          f"dbias) = {flags} in {len(needs.calls)} calls, on {card}",
          flush=True)
    if (w.shape != (g_cfg.num_ws, g_cfg.w_dim) or not np.isfinite(w).all()
            or not np.isfinite(float(loss)) or n != per * II2S_STEPS
            or len(needs.calls) != per * II2S_STEPS
            or needs.count(II2S_NEEDS) != per * II2S_STEPS):
        raise AssertionError("II2S failed")
    torch.backends.cudnn.allow_tf32 = False
    grads = {}
    for label, pallas in (("pallas", True), ("composed", False)):
        cfg_l = dataclasses.replace(g_cfg, synthesis=dataclasses.replace(
            g_cfg.synthesis, pallas_level=pallas))
        fn = ii2s.make_loss(cfg, cfg_l, params, ref, lpips, pca)
        latent = ii2s.initial_latent(cfg_l, params, Rng(31)).requires_grad_()
        (grads[label],) = torch.autograd.grad(fn(latent)[0], [latent])
    torch.backends.cudnn.allow_tf32 = True
    err = rel_l2({"w": grads["pallas"]}, {"w": grads["composed"]}, ["w"])
    print(f"II2S pallas vs composed (TF32 off): the first step's W+ gradient "
          f"rel_l2 {err:.4g} (bound {2 ** -4:.4g}), on {card}", flush=True)
    if not err <= 2 ** -4:
        raise AssertionError("II2S: pallas and composed gradients disagree")
    return n, flags


def edit_runs(params, ws, card):
    """On the ReStyle W+: an InterFaceGAN sweep (factor_range -2..2 of a
    seeded direction) rendered; two StyleSpace channel edits on the fused
    levels composed with a seeded s_delta direction both ways, rendered
    (they change the image: the edited styles reach the level); a zero edit
    without a base hook bit-equal to the plain render; StyleFlow at its
    real config (seeded, x0.01 as its init) editing Age under dopri5 and
    rk4: steps, host reads, time, the round trip within the solver's
    tolerance and the _PRESERVE layers unchanged.  Returns the fused
    launches."""
    g_cfg = inversion_g_config()
    syn, per = g_cfg.synthesis, expected_launches(g_cfg, 1)
    launches = 0

    def render(w, hooks=None):
        nonlocal launches
        fmc.fused_modconv3x3.launches = 0
        with torch.no_grad():
            img = sg2.synthesis_apply(syn, params["synthesis"], w,
                                      noise_mode="const", hooks=hooks)
        launches += fmc.fused_modconv3x3.launches
        if fmc.fused_modconv3x3.launches != expected_launches(g_cfg,
                                                              w.shape[0]):
            raise AssertionError("edit render: fused launches")
        return img

    direction = torch.randn((512,), generator=torch.Generator().manual_seed(
        41)).numpy()
    editor = editing.LatentEditor({"seeded": direction})
    sweep = editor.apply_interfacegan(ws, "seeded", factor_range=(-2, 3))
    imgs = render(sweep)
    print(f"InterFaceGAN: factor_range (-2, 3) of a seeded direction -> W+ "
          f"{tuple(sweep.shape)}, rendered {tuple(imgs.shape)}, finite "
          f"{bool(torch.isfinite(imgs).all())}", flush=True)
    if sweep.shape[0] != 5 or not bool(torch.isfinite(imgs).all()):
        raise AssertionError("InterFaceGAN edit failed")

    spec = offs_lib.OffsetsSpec.from_string("s_delta")
    gen = torch.Generator().manual_seed(42)
    offsets = sg2.tree_map(lambda t: (0.2 * torch.randn(
        t.shape, generator=gen)).to(DEVICE),
        offs_lib.init_offsets(Rng(0), syn, spec, DEVICE))
    base = offs_lib.make_hooks(spec, offsets)
    plain, based = render(ws), render(ws, base)
    moved = {}
    for apply_first in (False, True):
        hooks = editing.build_style_modification_hooks(syn, STYLE_EDITS, base,
                                                       apply_first)
        moved[apply_first] = float((render(ws, hooks) - based).abs().max())
    zero = editing.build_style_modification_hooks(syn, [((15, 3), 0.0, 1.0)])
    same = torch.equal(render(ws, zero), plain)
    print(f"StyleSpace: edits {STYLE_EDITS} with a seeded s_delta direction: "
          f"max|edited - direction only| {moved[False]:.4g} (direction "
          f"scaled, then the edit), {moved[True]:.4g} (the edit first); a "
          f"zero edit without a base hook bit-equal to the plain render "
          f"{same}; {per} fused launches a render", flush=True)
    if not (moved[False] > 0 and moved[True] > 0 and same):
        raise AssertionError("StyleSpace edits failed")

    w_plus = ws[:1].float()
    attrs = np.random.RandomState(43).uniform(0, 1, 8).astype(np.float32)
    light = np.random.RandomState(44).uniform(0, 1, 9).astype(np.float32)
    for solver in ("dopri5", "rk4"):
        cfg = styleflow.StyleFlowConfig(solver=solver)
        flow = styleflow.init_styleflow(Rng(45), cfg, DEVICE)
        editor = styleflow.StyleFlowEditor(flow, cfg, num_ws=g_cfg.num_ws)
        styleflow.DOPRI5_STATS.update(steps=0, host_reads=0)
        t0 = time.perf_counter()
        edited = editor.edit(w_plus, attrs, light, attr_idx=6,
                             edit_power=0.7)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = dict(styleflow.DOPRI5_STATS)
        x = w_plus.reshape(g_cfg.num_ws, -1)
        ctx = editor._context(light, attrs, DEVICE)
        styleflow.DOPRI5_STATS.update(steps=0, host_reads=0)
        z_ = styleflow.flow_apply(flow, cfg, x, ctx)
        back = styleflow.flow_apply(flow, cfg, z_, ctx, reverse=True)
        steps = (styleflow.DOPRI5_STATS["steps"] if solver == "dopri5"
                 else cfg.rk4_steps)
        err = float((back - x).abs().max())
        bound = 2 * steps * (cfg.atol + cfg.rtol * float(x.abs().max()))
        kept = all(torch.equal(edited[:, a:b], w_plus[:, a:b]) for a, b in
                   [(a, g_cfg.num_ws if b is None else b)
                    for a, b in styleflow._PRESERVE[6]])
        print(f"StyleFlow {solver} (512 in, 5 x 512 hidden, context 17): "
              f"Age edit in {wall:.4f} s, {stats['steps']} adaptive steps "
              f"and {stats['host_reads']} host reads (forward + reverse); "
              f"max|edit| {float((edited - w_plus).abs().max()):.4g}; "
              f"round trip max error {err:.4g} (bound {bound:.4g}: 2 x "
              f"{steps} steps x (atol + rtol max|w|)); _PRESERVE layers "
              f"unchanged {kept}, on {card}", flush=True)
        if not (err <= bound and kept and bool(torch.isfinite(edited).all())
                and float((edited - w_plus).abs().max()) > 0):
            raise AssertionError(f"StyleFlow {solver} failed")
    return launches


def latent_d_round(params, card):
    """e4e's adversary on w: real codes from the mapping, fake codes the
    ReStyle codes of RESTYLE_BATCH inputs through LatentCodesPool(POOL_SIZE);
    the logistic D loss, R1 and the G non-saturating loss, then D_STEPS
    Adam steps of D on D loss + 10 R1: all finite, D moved."""
    net, inputs = restyle_net(restyle_lib.RestyleEncoderConfig.encoder_type,
                              RESTYLE_BATCH, params)
    _, latents = restyle_lib.run_on_batch(net, inputs, n_iters=1)
    pool = e4e_training.LatentCodesPool(POOL_SIZE, seed=0)
    fake = torch.from_numpy(pool.query(latents[-1])).to(DEVICE)
    z = Rng(46).normal((RESTYLE_BATCH, 512), DEVICE)
    g_cfg = inversion_g_config()
    with torch.no_grad():
        real = sg2.mapping_apply(g_cfg.mapping, params["mapping"], z,
                                 broadcast=False)
    d = e4e_training.init_latent_discriminator(Rng(47), 512, 4, DEVICE)
    before = {k: t.clone() for k, t in ckpt.tree_to_flat_tensors(d).items()}
    tx = ts.Adam(1e-4, 0.9, 0.999, 1e-8)
    state = tx.init(d)
    losses = []
    for _ in range(D_STEPS):
        def loss_fn():
            d_loss = e4e_training.d_logistic_loss(
                e4e_training.latent_discriminator_apply(d, real),
                e4e_training.latent_discriminator_apply(d, fake))
            r1 = e4e_training.d_r1_loss(d, real)
            g_loss = e4e_training.g_nonsaturating_loss(
                e4e_training.latent_discriminator_apply(d, fake))
            return d_loss + 10.0 * r1, (d_loss, r1, g_loss)

        loss, metrics, grads = round_grads(loss_fn, {"d": d})
        tx.update_({k[2:]: g for k, g in grads.items()}, state, d)
        losses.append([float(v.detach()) for v in metrics])
    moved = max(float((t - before[k]).abs().max())
                for k, t in ckpt.tree_to_flat_tensors(d).items())
    print(f"e4e latent D: pool of {POOL_SIZE}, fake codes "
          f"{tuple(fake.shape)}; (D loss, R1, G loss) per step "
          + "; ".join(", ".join(f"{v:.6f}" for v in l) for l in losses)
          + f"; D moved {moved:.4g} in {D_STEPS} Adam steps, on {card}",
          flush=True)
    if not (all(np.isfinite(v) for l in losses for v in l) and moved > 0):
        raise AssertionError("e4e latent D failed")


def face_photo():
    """The face phase's seeded 1024^2 "photo": 32^2 noise, Pillow-bicubic
    upsampled (host-made, so the CPU route sees the same pixels)."""
    rng = np.random.RandomState(0)
    return resize_uint8(rng.randint(0, 256, (32, 32, 3)).astype(np.uint8),
                        (FACE_RES, FACE_RES), "bicubic")


def face_mtcnn(device):
    """MTCNN with random weights from FACE_MTCNN_SEED, its regression heads
    (P/R/O-Net box offsets, O-Net landmarks) scaled by 0.01 and O-Net's
    landmark bias set to the reference 5-point layout in box coordinates:
    at the init's scale the random offsets move boxes by whole box widths
    and put landmarks thousands of pixels away (a quad of ~1e5 pixels), so
    the alignment after them would pad the photo to ~6e4^2.  The
    classification heads keep their random weights."""
    net = face_mtcnn_lib.MTCNN(
        generator=torch.Generator().manual_seed(FACE_MTCNN_SEED),
        device=device)
    for name, layer in (("pnet", "conv4_2"), ("rnet", "conv5_2"),
                        ("onet", "conv6_2"), ("onet", "conv6_3")):
        net.params[name][layer]["w"].mul_(0.01)
    ref = face_align.get_reference_facial_points(default_square=True) / 112.0
    net.params["onet"]["conv6_3"]["b"].copy_(torch.from_numpy(
        np.concatenate([ref[:, 0], ref[:, 1]]).astype(np.float32)))
    return net


def face_g_config():
    """The generator behind e4e: FFHQ-1024 with the fused level."""
    return entry_config()


def face_phase(card):
    """A photo in front of e4e: the MTCNN cascade (seeded random weights,
    see face_mtcnn) on the card and on the CPU, the FFHQ alignment to
    1024^2 on the card (quad map at 4096^2 and Lanczos in torch) against
    the host route, MTCNN.align to 112^2, and inference.project_e4e of the
    aligned face (random e4e with rescaled convolutions, FFHQ-1024 G with
    the fused level) against pallas_level=False.

    Tolerances.  Detections: the same number of boxes, boxes and landmarks
    within 2 px: both routes resize the pyramid and the crops to Pillow's
    exact pixels and run the nets in fp32 (TF32 off), so their scores and
    offsets differ by ~1e-6; a box coordinate can still round the other
    way (np.round after stages 1 and 2: 1 px, carried into the landmarks).
    Alignment: 1 level (the quad map and the Lanczos are the same float64
    arithmetic on both devices; a sum that lands on a rounding boundary
    can move a pixel by 1).  e4e + G: the main phase's bounds, 2^-5
    relative RMS and 2^-3 of max|img|."""
    phase("face")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    img = face_photo()
    card_net, host_net = face_mtcnn(DEVICE), face_mtcnn("cpu")
    card_net.detect_faces(img, thresholds=FACE_THRESHOLDS)     # warm-up
    boxes, lms = card_net.detect_faces(img, thresholds=FACE_THRESHOLDS)
    counts = dict(face_mtcnn_lib.STAGE_COUNTS)
    card_s = dict(face_mtcnn_lib.STAGE_SECONDS)
    hboxes, hlms = host_net.detect_faces(img, thresholds=FACE_THRESHOLDS)
    host_s = dict(face_mtcnn_lib.STAGE_SECONDS)
    print(f"MTCNN on a {FACE_RES}^2 photo, thresholds {FACE_THRESHOLDS}: "
          f"boxes by stage {counts} (host route "
          f"{dict(face_mtcnn_lib.STAGE_COUNTS)}); seconds by stage, card "
          + ", ".join(f"{k} {v:.4f}" for k, v in card_s.items())
          + "; host " + ", ".join(f"{k} {v:.4f}" for k, v in host_s.items())
          + f"; on {card}", flush=True)
    if len(boxes) == 0:
        raise AssertionError("face: the cascade returned no box")
    if len(hboxes) != len(boxes):
        raise AssertionError(f"face: {len(boxes)} boxes on the card, "
                             f"{len(hboxes)} on the host")
    order = np.lexsort(np.round(boxes[:, :4]).T[::-1])
    horder = np.lexsort(np.round(hboxes[:, :4]).T[::-1])
    box_err = float(np.abs(boxes[order, :4] - hboxes[horder, :4]).max())
    lm_err = float(np.abs(lms[order] - hlms[horder]).max())
    print(f"card vs host detections: max |box| diff {box_err:.4g} px, max "
          f"|landmark| diff {lm_err:.4g} px (bound 2)")
    if not (box_err <= 2 and lm_err <= 2):
        raise AssertionError("face: card and host detections disagree")

    best = int(np.argmax(boxes[:, 4]))
    pts = np.stack([lms[best][:5], lms[best][5:]], axis=1)
    face_align.align_face_5p(img, pts, output_size=FACE_RES,
                             transform_size=FACE_TRANSFORM,
                             device=DEVICE)                   # warm-up
    t0 = time.perf_counter()
    face = face_align.align_face_auto(img, output_size=FACE_RES,
                                      transform_size=FACE_TRANSFORM,
                                      mtcnn=card_net, device=DEVICE)
    auto_s = time.perf_counter() - t0
    steps = dict(face_align.STEP_SECONDS)
    host_face = face_align.align_face_5p(img, pts, output_size=FACE_RES,
                                         transform_size=FACE_TRANSFORM,
                                         device="cpu")
    host_steps = dict(face_align.STEP_SECONDS)
    diff = np.abs(face.astype(int) - host_face.astype(int))
    print(f"align_face_auto to {FACE_RES}^2 (transform {FACE_TRANSFORM}): "
          f"{auto_s:.3f} "
          f"s on the card with detection; steps, card "
          + ", ".join(f"{k} {v:.4f}" for k, v in steps.items())
          + " s; host route " + ", ".join(f"{k} {v:.4f}" for k, v in
                                          host_steps.items())
          + f" s; card vs host max diff {int(diff.max())} levels, "
          f"{100 * float((diff > 0).mean()):.4f}% of values differ "
          f"(bound 1); on {card}", flush=True)
    if face.shape != (FACE_RES, FACE_RES, 3) or diff.max() > 1 \
            or face.std() == 0:
        raise AssertionError("face: card and host alignments disagree")
    face112, tfm = card_net.align(img)
    if face112 is None or face112.shape != (112, 112, 3):
        raise AssertionError("face: MTCNN.align failed")
    print(f"MTCNN.align: {face112.shape}, transform "
          f"{np.round(tfm, 4).tolist()}")

    e_cfg = enc_lib.EncoderConfig(stylegan_size=face_g_config().img_resolution)
    e_params = enc_lib.init_encoder(torch.Generator().manual_seed(5), e_cfg,
                                    DEVICE)
    rescale_random_convs(e_params)
    g_cfg = face_g_config()
    g_params = sg2.init_generator(g_cfg, torch.Generator().manual_seed(0),
                                  DEVICE)
    z = torch.randn((4096, g_cfg.z_dim),
                    generator=torch.Generator().manual_seed(2)).to(DEVICE)
    with torch.no_grad():
        w_avg = sg2.mapping_apply(g_cfg.mapping, g_params["mapping"], z,
                                  broadcast=False).mean(dim=0)
    avg = w_avg[None].repeat(g_cfg.num_ws, 1)
    fmc.fused_modconv3x3.launches = 0
    rec, ws = inference.project_e4e(face, e_cfg, e_params, g_cfg, g_params,
                                    latent_avg=avg)
    torch.cuda.synchronize()
    launches = fmc.fused_modconv3x3.launches
    plain = dataclasses.replace(g_cfg, synthesis=dataclasses.replace(
        g_cfg.synthesis, pallas_level=False))
    ref, ref_ws = inference.project_e4e(face, e_cfg, e_params, plain,
                                        g_params, latent_avg=avg)
    diff = (rec - ref).float()
    rel_rms = float(diff.square().mean().sqrt() / ref.square().mean().sqrt())
    max_err = float(diff.abs().max())
    peak = float(ref.abs().max())
    torch.backends.cudnn.allow_tf32 = True
    ms = wall_ms(lambda: inference.project_e4e(
        face, e_cfg, e_params, g_cfg, g_params, latent_avg=avg), 5)
    print(f"project_e4e of the aligned face: {tuple(rec.shape)}, "
          f"|w+| rms {float(ws.square().mean().sqrt()):.4g}, fused launches "
          f"{launches} (expected {expected_launches(g_cfg, 1)}); vs "
          f"pallas_level=False: rel_rms {rel_rms:.4g} (bound "
          f"{2 ** -5:.4g}), max_abs_err {max_err:.4g} (bound "
          f"{2 ** -3 * peak:.4g}); e4e + G {ms:.3f} ms a call (TF32 "
          f"convolutions on); on {card}", flush=True)
    if not (launches == expected_launches(g_cfg, 1)
            and tuple(rec.shape) == (1, 3, FACE_RES, FACE_RES)
            and bool(torch.isfinite(rec).all())
            and torch.equal(ws, ref_ws)
            and rel_rms <= 2 ** -5 and max_err <= 2 ** -3 * peak):
        raise AssertionError("face: e4e reconstruction failed")
    return launches


# ----------------------------------------------------------------------------
# The train state, the packed tail, the examples and the model zoo


def state_phase(keep, card):
    """save_train_state / load_train_state of the train phase's FFHQ-1024
    state (G, D, G_ema, both Adam states, ADA p, pl_mean, the image count):
    every leaf bit-equal after the round trip, on the state's devices and
    dtypes; the bytes on disk and the save and load seconds.  Then one
    "none" step from the restored state and two from copies of the
    original, under the same draws and PyTorch's deterministic algorithms
    (warn only): the restored step may differ from the original one only as
    much as two original steps differ from each other, run-to-run
    (ROADMAP section 3 item 2); bound 4 times that difference, relative L2
    over G's and over D's weights, as the remat phase argues (one pair is
    one sample of that noise), which is 0 when the two runs are
    bit-equal."""
    import copy

    phase("state")
    steps, state, (real, _, z, _, key) = (keep["steps"], keep["state"],
                                          keep["inputs"])
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_train_state(tmp, STATE_STEP, state)
        save_s = time.perf_counter() - t0
        path = os.path.join(tmp, f"step_{STATE_STEP:08d}", "state.pt")
        size = os.path.getsize(path)
        if ckpt.latest_step(tmp) != STATE_STEP:
            raise AssertionError("state: latest_step")
        t0 = time.perf_counter()
        restored = ckpt.load_train_state(tmp, STATE_STEP, state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    a, b = ckpt.train_state_leaves(state), ckpt.train_state_leaves(restored)
    groups = collections.Counter(k.split("/")[0] for k in a)
    for need in ("g_params", "d_params", "g_ema", "g_opt_state",
                 "d_opt_state", "ada_p"):
        if not groups[need]:
            raise AssertionError(f"state: no {need} leaves")
    bad = [k for k, v in a.items()
           if (not (torch.is_tensor(b[k]) and v.dtype == b[k].dtype
                    and v.device == b[k].device and torch.equal(v, b[k]))
               if torch.is_tensor(v) else v != b[k])]
    n_bytes = sum(v.numel() * v.element_size() for v in a.values()
                  if torch.is_tensor(v))
    print(f"state: {len(a)} leaves ({dict(groups)}), {n_bytes / 2 ** 30:.4f} "
          f"GiB of tensors, {size} bytes on disk ({size / 2 ** 30:.4f} GiB); "
          f"save {save_s:.3f} s, load {load_s:.3f} s on {card}")
    if bad:
        raise AssertionError(f"state: {len(bad)} leaves differ after the "
                             f"round trip, e.g. {bad[:3]}")

    runs = {}
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    launches = 0
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for label, start in (("original", copy.deepcopy(state)),
                                 ("original again", copy.deepcopy(state)),
                                 ("restored", restored)):
                fmc.fused_modconv3x3.launches = 0
                runs[label], _ = steps["none"](start, real, None, z, None,
                                               key.fold_in(50))
                torch.cuda.synchronize()
                launches += fmc.fused_modconv3x3.launches
                del start
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = cudnn_det
    for group in ("g_params", "d_params"):
        flat = {k: ckpt.tree_to_flat_tensors(getattr(r, group))
                for k, r in runs.items()}
        keys = list(flat["original"])
        floor = rel_l2(flat["original again"], flat["original"], keys)
        err = rel_l2(flat["restored"], flat["original"], keys)
        print(f"state: one 'none' step, {group}: restored vs original "
              f"rel_l2 {err:.4g}, original vs original {floor:.4g}, bound "
              f"{4 * floor:.4g} (deterministic algorithms)")
        if not err <= 4 * floor:
            raise AssertionError(f"state: the restored step's {group} "
                                 f"differ from the original step's")
    return launches


def tail_config(tail_blocks, fused=True, architecture="skip",
                pallas_level=True, packed=True) -> sg2.GeneratorConfig:
    cfg = entry_config(pallas_level)
    return dataclasses.replace(cfg, synthesis=dataclasses.replace(
        cfg.synthesis, packed_last_block=packed,
        packed_tail_blocks=tail_blocks, packed_fused_torgb=fused,
        architecture=architecture))


def tail_phase(card, train_none_s):
    """The FFHQ-1024 forward (entry_config's G, random weights with noise
    and biases seeded) with packed_tail_blocks 1, 2 and 3, with the fused
    torgb and without, and an architecture="orig" G (unpacked: the packed
    tail needs "skip"): each held against the unpacked composed forward
    (pallas_level=False, packed_last_block=False; for "orig" the "orig" G's)
    at batch 8 with TF32 off within the main phase's bounds (2^-5 relative
    RMS, 2^-3 of max|img|), its fused launches against expected_launches,
    and its ms per forward at batch 32 (TF32 convolutions on).  Then one
    "none" train step at batch 32 with packed_tail_blocks=2 (checked, then
    timed) beside the train phase's with 1."""
    phase("tail")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res, z_dim = entry_config().img_resolution, entry_config().z_dim
    params = seeded_weights(sg2.init_generator(
        entry_config(), torch.Generator().manual_seed(0), DEVICE))
    last = f"b{res}"
    orig_params = {"mapping": params["mapping"], "synthesis": {
        k: {n: v for n, v in blk.items() if n != "torgb" or k == last}
        for k, blk in params["synthesis"].items()}}
    z = torch.randn((BATCH, z_dim), generator=torch.Generator().manual_seed(1)
                    ).to(DEVICE)
    zt = torch.randn((TIMED_BATCH, z_dim),
                     generator=torch.Generator().manual_seed(2)).to(DEVICE)

    def forward(cfg, p, z):
        with torch.no_grad():
            return sg2.generator_apply(cfg, p, z, noise_mode="const")

    refs = {arch: forward(tail_config(1, architecture=arch, pallas_level=False,
                                      packed=False), p, z)
            for arch, p in (("skip", params), ("orig", orig_params))}
    variants = [(f"{n} block{'s' if n > 1 else ''}, "
                 f"{'fused' if fused else 'unfused'} torgb",
                 tail_config(n, fused), params, "skip")
                for n in TAIL_BLOCKS for fused in (True, False)]
    variants.append(("orig", tail_config(1, architecture="orig"),
                     orig_params, "orig"))
    total, ms = 0, {}
    for label, cfg, p, arch in variants:
        fmc.fused_modconv3x3.launches = 0
        img = forward(cfg, p, z)
        torch.cuda.synchronize()
        launches = fmc.fused_modconv3x3.launches
        total += launches
        want = expected_launches(cfg, BATCH)
        ref = refs[arch]
        peak = float(ref.abs().max())
        diff = (img - ref).float()
        rel_rms = float(diff.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
        max_err = float(diff.abs().max())
        torch.backends.cudnn.allow_tf32 = True
        ms[label] = time_ms(lambda: forward(cfg, p, zt), iters=3, warmup=1)
        torch.backends.cudnn.allow_tf32 = False
        print(f"tail {label}: fused launches {launches} (expected {want}), "
              f"vs the unpacked composed forward max_abs_err {max_err:.4g} "
              f"(max|img| {peak:.4g}) rel_rms {rel_rms:.4g}; "
              f"{ms[label]:.3f} ms per batch-{TIMED_BATCH} forward on {card}",
              flush=True)
        if launches != want or tuple(img.shape) != (BATCH, 3, res, res):
            raise AssertionError(f"tail {label}: {launches} launches, "
                                 f"{tuple(img.shape)}")
        if not (rel_rms <= 2 ** -5 and max_err <= 2 ** -3 * peak):
            raise AssertionError(f"tail {label}: disagrees with the "
                                 f"unpacked composed forward")
    del refs, img, ref, diff

    torch.backends.cudnn.allow_tf32 = True
    steps, state, (real, _, z, _, key) = train_entry(
        DEVICE, batch=TRAIN_BATCH, ada_p=0.2, packed_tail_blocks=TAIL_TRAIN)
    run = train_run(TRAIN_BATCH, packed_tail_blocks=TAIL_TRAIN)
    g_cfg, cfg = run.g_cfg, run.train_cfg
    want = (expected_launches(g_cfg, TRAIN_BATCH // cfg.accum_rounds)
            * cfg.accum_rounds)
    fmc.fused_modconv3x3.launches = 0
    state, metrics = steps["none"](state, real, None, z, None, key)
    torch.cuda.synchronize()
    launches = fmc.fused_modconv3x3.launches
    total += launches
    if (launches != want or not g_cfg.synthesis.packed_tail_blocks == TAIL_TRAIN
            or not all(bool(torch.isfinite(v).all())
                       for v in metrics.values())):
        raise AssertionError(f"tail train step: {launches} launches "
                             f"(expected {want}) or non-finite metrics")
    t0 = time.perf_counter()
    steps["none"](state, real, None, z, None, key.fold_in(1))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"tail train 'none' step, batch {TRAIN_BATCH}, packed_tail_blocks "
          f"{TAIL_TRAIN}: {seconds:.4f} s (the train phase's with 1: "
          f"{train_none_s:.4f} s), fused launches {launches} (expected "
          f"{want}) on {card}", flush=True)
    return total


# The number of G forwards each example makes (quick_start: 16 seeds in one
# batch; editing: 3 alphas and a StyleSpace edit; adaptation_inference:
# source and adapted; morphing: 5 blends and the joint one; pruned_forward:
# 4 sparsities) and the PNGs each writes at 1024^2, with their shapes.
EXAMPLE_FORWARDS = {"quick_start": 1, "editing": 4, "adaptation_inference": 2,
                    "morphing": 6, "pruned_forward": 4}
EXAMPLE_PNGS = {
    "quick_start": {"quick_start_grid.png": (512, 2048, 3)},
    "editing": {"interfacegan_sweep.png": (256, 768, 3),
                "stylespace_edit.png": (256, 256, 3)},
    "adaptation_inference": {f"pair_{i:02d}.png": (256, 512, 3)
                             for i in range(4)},
    "morphing": {**{f"blend_{i:02d}.png": (256, 1024, 3) for i in range(5)},
                 "combined.png": (256, 1024, 3)},
    "pruned_forward": {"pruned_sweep.png": (1024, 1024, 3)},
}


def examples_phase(tmp, card):
    """The five examples' main (gagan_tpu_torch/examples) at FFHQ-1024 on
    entry.examples_entry's seeded snapshot and two adaptation checkpoints,
    as their command lines give them, TF32 off: each PNG reads back at its
    shape with some spread of values; the fused launches of each (2 a G
    forward) and its wall time; then the same calls on a snapshot with
    pallas_level=False (the same weights), whose PNGs each example's must
    match within the main phase's bounds, read as [-1, 1]: 2^-5 relative
    RMS, and 2^-3 of max|img| of the float images (quick_start's 16
    images from the composed G; clipping to [-1, 1] and the averaging
    resizes shrink a difference, never grow it) plus one uint8 level for
    the rounding."""
    import importlib

    phase("examples")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = examples_config(EXAMPLES_RES)
    written, total = {}, 0
    for label, pallas in (("fused", True), ("composed", False)):
        argvs = examples_entry(DEVICE, EXAMPLES_RES,
                               os.path.join(tmp, f"examples_{label}"),
                               pallas_level=pallas)
        for name, argv in argvs.items():
            module = importlib.import_module(f"gagan_tpu_torch.examples.{name}")
            torch.cuda.synchronize()
            fmc.fused_modconv3x3.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                paths = module.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = fmc.fused_modconv3x3.launches
            want = (expected_launches(cfg, 1) * EXAMPLE_FORWARDS[name]
                    if pallas else 0)
            names = {os.path.basename(p): p for p in paths}
            print(f"examples {name} ({label}): {len(paths)} PNGs, fused "
                  f"launches {launches} (expected {want}), {seconds:.3f} s "
                  f"on {card}", flush=True)
            if launches != want or set(names) != set(EXAMPLE_PNGS[name]):
                raise AssertionError(f"examples {name}: {launches} launches, "
                                     f"PNGs {sorted(names)}")
            for fname, path in names.items():
                img = png.read_png(path)
                if img.shape != EXAMPLE_PNGS[name][fname] or img.std() < 1:
                    raise AssertionError(f"examples {name}/{fname}: "
                                         f"{img.shape}, std {img.std()}")
                written[label, name, fname] = img
            total += launches
    g_cfg, g_params = generate.load_generator(
        os.path.join(tmp, "examples_composed", "G.npz"), DEVICE)
    with torch.no_grad():
        peak = float(sg2.generator_apply(
            g_cfg, g_params, numpy_latents(range(16), g_cfg.z_dim, DEVICE),
            truncation_psi=0.7).abs().max())
    del g_params
    for (label, name, fname), img in written.items():
        if label != "fused":
            continue
        a = img.astype(np.float64) / 127.5 - 1
        b = written["composed", name, fname].astype(np.float64) / 127.5 - 1
        rel_rms = float(np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))
        max_err = float(np.abs(a - b).max())
        if not (rel_rms <= 2 ** -5 and max_err <= 2 ** -3 * peak + 1 / 127.5):
            raise AssertionError(f"examples {name}/{fname}: fused vs composed "
                                 f"rel_rms {rel_rms:.4g} max {max_err:.4g}")
    worst = max(
        float(np.abs(img.astype(np.int32)
                     - written["composed", n, f].astype(np.int32)).max())
        for (label, n, f), img in written.items() if label == "fused")
    print(f"examples: every PNG within the bounds of its pallas_level=False "
          f"run (the largest difference {worst:.0f} uint8 levels, bound "
          f"{(2 ** -3 * peak + 1 / 127.5) * 127.5:.1f}: max|img| {peak:.4g})")
    return total


def zoo_phase(tmp, card):
    """make_generator of each zoo model (entry.zoo_entry): stylegan2 from
    an FFHQ-1024 snapshot (entry_config's G, seeded), proggan at 1024^2,
    sn_anime (sn_resnet128), sn_mnist (sn_resnet32) and biggan at
    BigGAN-PyTorch's 128^2 widths.  forward and gen_shifted at batch 8
    (finite, shaped, the shift moving the images), images/s of forward
    (TF32 convolutions on); then the card against the same handle on the
    CPU at batch 1 in fp32 with TF32 off (biggan with its class given),
    within 2^-12 of max|img| (convolutions summed in another order, ~1e-6
    a layer).  The bf16 blocks of the FFHQ-1024 G round elsewhere on the
    card (the fused levels) than on the CPU, so stylegan2 is held on an fp32 copy of its snapshot (num_fp16_res 0:
    the card's fused levels take the fp32 route)."""
    phase("zoo")
    g = seeded_weights(sg2.init_generator(
        entry_config(), torch.Generator().manual_seed(0), "cpu"))
    snaps = {}
    for label, cfg in (("bf16", entry_config()), ("fp32", dataclasses.replace(
            entry_config(), synthesis=dataclasses.replace(
                entry_config().synthesis, num_fp16_res=0)))):
        snaps[label] = os.path.join(tmp, f"zoo_stylegan2_{label}.npz")
        ckpt.save_snapshot(snaps[label], g_ema=g,
                           config={"g_cfg": config_lib.to_dict(cfg)})
    del g
    launches_total = 0
    for name in ZOO_MODELS:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        handle, z = zoo_entry(DEVICE, name, ZOO_BATCH,
                              snapshot_path=snaps["bf16"])
        shift = 0.5 * torch.randn((ZOO_BATCH, handle.dim_shift),
                                  generator=torch.Generator().manual_seed(3)
                                  ).to(DEVICE)
        fmc.fused_modconv3x3.launches = 0
        with torch.no_grad():
            img = handle.forward(z)
            moved = handle.gen_shifted(z, shift)
        torch.cuda.synchronize()
        launches = fmc.fused_modconv3x3.launches
        launches_total += launches
        want = 2 * expected_launches(entry_config(), ZOO_BATCH) \
            if name == "stylegan2" else 0
        if (launches != want or img.shape != moved.shape
                or img.shape[0] != ZOO_BATCH or img.shape[1] != 3
                or not bool(torch.isfinite(img).all())
                or not bool(torch.isfinite(moved).all())
                or not float((moved - img).abs().max()) > 0):
            raise AssertionError(f"zoo {name}: {launches} launches (expected "
                                 f"{want}), {tuple(img.shape)}")

        def run():
            with torch.no_grad():
                return handle.forward(z)
        ms = time_ms(run, iters=3, warmup=1)
        # The card against the CPU, batch 1, TF32 off, fp32 throughout.
        torch.backends.cudnn.allow_tf32 = False
        kw = {"class_ids": [239]} if name == "biggan" else {}
        with torch.no_grad():
            card_h, _ = zoo_entry(DEVICE, name, 1, snapshot_path=snaps["fp32"])
            got = card_h.forward(z[:1], **kw).cpu()
            cpu_h, _ = zoo_entry("cpu", name, 1, snapshot_path=snaps["fp32"])
            want_img = cpu_h.forward(z[:1].cpu(), **kw)
        peak = float(want_img.abs().max())
        max_err = float((got - want_img).abs().max())
        ok = max_err <= 2 ** -12 * peak
        print(f"zoo {name}: {tuple(img.shape[1:])}, "
              f"{ZOO_BATCH / ms * 1e3:.2f} images/s at batch {ZOO_BATCH} "
              f"({ms:.3f} ms), fused launches {launches} (forward + "
              f"gen_shifted); card vs CPU at batch 1 in fp32 max_abs_err "
              f"{max_err:.4g} (max|img| {peak:.4g}, bound 2^-12 of it) on "
              f"{card}", flush=True)
        if not ok:
            raise AssertionError(f"zoo {name}: the card and the CPU disagree")
        del handle, card_h, cpu_h, img, moved
        torch.cuda.empty_cache()
    return launches_total


# ----------------------------------------------------------------------------
# dist: data parallelism over torch.distributed ranks (parallel/mesh.py)

# Each collective of a dist rank, and each spawn of the ranks, ends within
# this many seconds; a rank that fails or hangs fails the phase.
DIST_TIMEOUT = 600
# The loop's batches over two ranks, and the resume cycle's global batch.
DIST_LOOP_BATCHES, DIST_RESUME_BATCH = 4, 8
# Two ranks against one process.  The comparison runs G and D and the ADA
# pipe in fp32 (TF32 off, deterministic algorithms), at global batch
# DIST_CHECK_BATCH in rounds of DIST_CHECK_BATCH_GPU a rank, so that what
# differs between the two is fp32 summation order: the ranks run every
# convolution at half the batch and add the halves' gradients in the
# all_reduce.  (In bf16 the batch sums of the weight gradients round at
# other places when the batch is split, which moved G's conv1 weights by
# 3.4e-2 with no collective at all: no bound could then tell a fault.)  The
# step runs at learning rate 0, so that every phase of a variant starts
# from the same parameters in both runs (Adam's first step, lr * g / (|g|
# + 1e-8), would move each element by +-lr wherever rounding decides the
# sign of a g near 0), and Adam's first moment holds each net's last
# phase's gradient (beta1 is 0): Gmain / Dmain in "none", Greg in "greg",
# Greg / Dreg in "both".  Each quantity has its own bound, 16 times the
# largest reading of the first fp32 run on the H100 (PERF.md §6),
# rounded up to a power of two: G's gradient by its phase (Gmain in "none",
# 6.2e-7; Greg, 6.0e-4: the path length is the VJP of the image against
# random noise, a sum over 3M pixels that cancels, and the two runs' cuDNN
# sums it in another order at another batch), D's (Dmain and Dreg, 1.1e-6),
# the loss metrics by phase (main 8.7e-8; the regularizers' 1.8e-4),
# pl_mean (9.2e-5) and w_avg (read 0: the bound stands at 2^-20).  A net's
# gradient is held by its relative L2 over the whole net (a single leaf
# whose gradient is a cancelling sum, a noise strength, can move by more
# than its own size).  Two faults that leave the ranks bit-equal, so that
# check_replica_consistency cannot see them, are planted in the same run
# and must fail these bounds (DIST_FAULTS): the minibatch stddev over each
# rank's rows alone (in "none"), and every rank taking the first rows of
# each draw, a wrong share of the noise, the mixing, the ADA pipe's and
# PL's draws (in "greg").
DIST_CHECK_BATCH, DIST_CHECK_BATCH_GPU = 8, 2
DIST_BOUNDS = {"G main": 2 ** -16, "G reg": 2 ** -6, "D": 2 ** -15,
               "loss main": 2 ** -19, "loss reg": 2 ** -8,
               "pl_mean": 2 ** -9, "w_avg": 2 ** -20}
DIST_VARIANTS = tuple(v for v, _, _ in dryrun.VARIANTS)


def _dist_settings():
    """Deterministic algorithms (warn only: an op without one runs as
    before) and TF32 off, in a dist rank."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)


def _timed_step(step, state, inputs) -> float:
    s = copy.deepcopy(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(s, *inputs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _grad_leaves(state):
    """Each net's last gradient (Adam's first moment), ``pl_mean``,
    ``ada_p`` and ``w_avg``, on the host."""
    out = {f"G/{k}": v.detach().cpu().clone()
           for k, v in state.g_opt_state.mu.items()}
    out.update({f"D/{k}": v.detach().cpu().clone()
                for k, v in state.d_opt_state.mu.items()})
    for k, v in (("pl_mean", state.pl_mean), ("ada_p", state.ada_p),
                 ("w_avg", state.g_params["mapping"]["w_avg"])):
        out[k] = v.detach().cpu().clone()
    return out


def _rel_l2_by_net(got, want):
    """{"G": ..., "D": ...}: each net's gradient relative L2 over all its
    leaves, and (relative L2, leaf) of its worst leaf."""
    out = {}
    for net in ("G", "D"):
        num = den = 0.0
        worst = (0.0, "")
        for k, w in want.items():
            if not k.startswith(net + "/"):
                continue
            d2, w2 = float((got[k] - w).square().sum()), float(w.square().sum())
            num, den = num + d2, den + w2
            if w2 > 0 and np.sqrt(d2 / w2) > worst[0]:
                worst = (float(np.sqrt(d2 / w2)), k)
        if den > 0:
            out[net] = (float(np.sqrt(num / den)), worst)
    return out


def _compare_grads(got, want, got_metrics, want_metrics):
    """Each net's gradient relative L2 (and its worst leaf); the relative
    error of ``pl_mean`` and ``w_avg``; ``ada_p``'s difference; the largest
    relative difference of a loss metric, of the main phases and of the
    regularizers apart (the signs and the GA share count samples)."""

    def rel(k):
        return float((got[k] - want[k]).norm() / max(float(want[k].norm()),
                                                     1e-30))
    loss = {"main": 0.0, "reg": 0.0}
    for k, v in want_metrics.items():
        if k.startswith("Loss/") and "/signs/" not in k and "/ga/" not in k:
            part = "reg" if ("reg" in k or "penalty" in k) else "main"
            loss[part] = max(loss[part], float(
                abs(got_metrics[k] - v) / max(abs(float(v)), 1e-30)))
    return {"nets": _rel_l2_by_net(got, want), "pl_mean": rel("pl_mean"),
            "w_avg": rel("w_avg"), "loss": loss,
            "ada_p": float((got["ada_p"] - want["ada_p"]).abs())}


def dist_one_rank(mesh):
    """The NCCL world of one: the three variants at FFHQ-1024, batch 32,
    through the mesh, then in the same process without it; the states'
    digests, launches and the warm s/step of "none" both ways."""
    _dist_settings()
    steps, state, inputs = dp_train_entry(mesh, batch=TRAIN_BATCH, ada_p=0.2)
    dp = dryrun.run_variants(mesh, steps, state, inputs, DIST_VARIANTS,
                             keep=dryrun.state_digest)
    dp_s = _timed_step(steps["none"], state, inputs)
    del steps, state, inputs
    torch.cuda.empty_cache()
    steps, state, inputs = train_entry(mesh.device, batch=TRAIN_BATCH,
                                       ada_p=0.2)
    ref = dryrun.run_variants(None, steps, state, inputs, DIST_VARIANTS,
                              keep=dryrun.state_digest)
    ref_s = _timed_step(steps["none"], state, inputs)
    return {"dp": dp, "ref": ref, "dp_s": dp_s, "ref_s": ref_s}


def _fault_mbstd_per_rank():
    """The minibatch stddev over the rank's rows alone."""
    orig = sg2.minibatch_std

    def per_rank(x, group_size, num_channels=1, shard=None):
        return orig(x, group_size, num_channels, None)
    return sg2, "minibatch_std", per_rank


def _fault_first_rows():
    """Every rank takes the first rows of each draw, not its own."""
    def first_rows(self, fn, shape, *args, device):
        return fn(tuple(shape), *args, device=device)
    return mesh_lib.ShardedRng, "_draw", first_rows


# Faults planted in the dist step check (see DIST_BOUNDS), and the variant
# each runs in.
DIST_FAULTS = {"mbstd over a rank's rows": (_fault_mbstd_per_rank, "none"),
               "first rows of every draw": (_fault_first_rows, "greg")}


def _dist_timing(mesh):
    """(2a) The train phase's plan for two devices in bf16 at global batch 32
    (16 a rank in the loop's rounds of 8): "none" twice, the second timed;
    its fused launches, the gradient all_reduce alone, the peak memory."""
    torch.cuda.reset_peak_memory_stats(mesh.device)
    steps, state, inputs = dp_train_entry(mesh, batch=TRAIN_BATCH, ada_p=0.2)
    none = dryrun.run_variants(mesh, steps, state, inputs, ("none",),
                               keep=lambda s: None)["none"]
    none["s"] = _timed_step(steps["none"], state, inputs)
    peak = torch.cuda.max_memory_allocated(mesh.device)
    n = sum(v.numel() for v in state.g_opt_state.mu.values()) + sum(
        v.numel() for v in state.d_opt_state.mu.values())
    bucket = torch.ones(n, device=mesh.device)
    mesh.all_reduce_(bucket)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        mesh.all_reduce_(bucket)
    torch.cuda.synchronize()
    out = {"launches": none["launches"], "none_s": none["s"], "peak": peak,
           "allreduce_ms": (time.perf_counter() - t0) / 3 * 1e3,
           "allreduce_mib": n * 4 / 2 ** 20}
    del steps, state, inputs, bucket
    return out


def _dist_check(mesh):
    """(2b) Two ranks against one process (DIST_BOUNDS): the three variants
    in fp32 at global batch DIST_CHECK_BATCH and learning rate 0, each
    rank's gradients kept, and each planted fault (DIST_FAULTS) in its
    variant; rank 0 then runs the one-process step of the same plan on the
    whole batch while rank 1 waits, and compares."""
    out = {}
    check = dict(batch=DIST_CHECK_BATCH, ada_p=0.2, lrate=0.0, fp32=True,
                 batch_gpu=DIST_CHECK_BATCH_GPU)
    steps, state, inputs = dp_train_entry(mesh, **check)
    runs = dryrun.run_variants(mesh, steps, state, inputs, DIST_VARIANTS,
                               keep=_grad_leaves)
    faults = {}
    for name, (plant, variant) in DIST_FAULTS.items():
        owner, attr, fn = plant()
        orig = getattr(owner, attr)
        setattr(owner, attr, fn)
        try:
            faults[name] = dryrun.run_variants(
                mesh, steps, state, inputs, (variant,),
                keep=_grad_leaves)[variant]
        finally:
            setattr(owner, attr, orig)
    out["check_launches"] = {v: r["launches"] for v, r in runs.items()}
    out["check_s"] = {v: r["s"] for v, r in runs.items()}
    del steps, state, inputs
    torch.cuda.empty_cache()
    mesh.barrier()
    if mesh.rank == 0:
        torch.cuda.reset_peak_memory_stats(mesh.device)
        steps, state, inputs = train_entry(mesh.device, n_devices=2, **check)
        ref = dryrun.run_variants(None, steps, state, inputs, DIST_VARIANTS,
                                  keep=_grad_leaves)
        out["ref_peak"] = torch.cuda.max_memory_allocated(mesh.device)
        out["ref_s"] = {v: r["s"] for v, r in ref.items()}
        out["compare"] = {v: _compare_grads(
            runs[v]["state"], ref[v]["state"], runs[v]["metrics"],
            ref[v]["metrics"]) for v in DIST_VARIANTS}
        out["faults"] = {name: _compare_grads(
            f["state"], ref[v]["state"], f["metrics"], ref[v]["metrics"])
            for (name, f), (_, v) in zip(faults.items(),
                                         DIST_FAULTS.values())}
        del steps, state, inputs, ref
        torch.cuda.empty_cache()
    mesh.barrier()
    return out


def _dist_breaks(c, variant: str) -> list:
    """The quantities of ``variant``'s comparison (:func:`_compare_grads`)
    past their DIST_BOUNDS (G's by its last phase), and a changed ada_p."""
    got = {"G main" if variant == "none" else "G reg": c["nets"]["G"][0],
           "D": c["nets"]["D"][0], "loss main": c["loss"]["main"],
           "loss reg": c["loss"]["reg"], "pl_mean": c["pl_mean"],
           "w_avg": c["w_avg"]}
    bad = [k for k, v in got.items() if not v <= DIST_BOUNDS[k]]
    return bad + (["ada_p"] if c["ada_p"] != 0 else [])


def _dist_reading(c) -> str:
    nets = c["nets"]
    return (f"gradient relative L2 G {nets['G'][0]:.4g}, D {nets['D'][0]:.4g}"
            f" (worst leaves {nets['G'][1][0]:.4g} {nets['G'][1][1]}, "
            f"{nets['D'][1][0]:.4g} {nets['D'][1][1]}); loss metrics main "
            f"{c['loss']['main']:.4g}, regularizers {c['loss']['reg']:.4g}; "
            f"pl_mean {c['pl_mean']:.4g}, w_avg {c['w_avg']:.4g}, ada_p "
            f"{c['ada_p']:.4g}")


def _dist_loop_config(run, run_dir, n_devices):
    kimg = DIST_LOOP_BATCHES * LOOP_BATCH / 1000
    return dataclasses.replace(
        run.loop_cfg, run_dir=run_dir, total_kimg=kimg, kimg_per_tick=kimg,
        image_snapshot_ticks=None, network_snapshot_ticks=1,
        log_param_histograms=False, n_devices=n_devices)


def _dist_loop(mesh, data, out_dir):
    """(3) cli/train.py's run (the plan for two devices) on the zip for
    DIST_LOOP_BATCHES batches, each rank in a run directory of its own:
    the files each wrote, its loader and its wait on it, its launches."""
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.reset_peak_memory_stats(mesh.device)
    run = train_cli.build_run(LOOP_RES, batch=LOOP_BATCH, n_devices=2,
                              snap=1, seed=0)
    run_dir = os.path.join(out_dir, "dist_run", f"rank{mesh.rank}")
    dataset, _ = train_cli.open_dataset(data, random_seed=0)
    taken, loaders = [], []
    orig = (loop_lib.data_loader, loop_lib.nl.native_data_loader)

    def timed(name, fn):
        def make(*a, **k):
            taken.append(name)
            loaders.append(TimedLoader(fn(*a, **k)))
            return loaders[-1]
        return make

    loop_lib.data_loader = timed("data_loader", orig[0])
    loop_lib.nl.native_data_loader = timed("native_data_loader", orig[1])
    fmc.fused_modconv3x3.launches = 0
    t0 = time.perf_counter()
    try:
        state = loop_lib.training_loop(
            _dist_loop_config(run, run_dir, 2), run.train_cfg, run.g_cfg,
            run.d_cfg, dataset, augment_cfg=run.augment_cfg,
            reg_remat=run.reg_remat, mesh=mesh)
        torch.cuda.synchronize()
    finally:
        loop_lib.data_loader, loop_lib.nl.native_data_loader = orig
    files = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []
    stats = []
    if "stats.jsonl" in files:
        with open(os.path.join(run_dir, "stats.jsonl")) as f:
            stats = [json.loads(ln) for ln in f if ln.strip()]
    torch.backends.cudnn.allow_tf32 = False
    return {"taken": taken, "wait": loaders[0].wait_s,
            "batches": loaders[0].batches, "files": files, "stats": stats,
            "launches": fmc.fused_modconv3x3.launches,
            "wall": time.perf_counter() - t0, "cur_nimg": state.cur_nimg,
            "peak": torch.cuda.max_memory_allocated(mesh.device),
            "rounds": run.train_cfg.accum_rounds}


def _dist_ga(mesh, population, z):
    """(4) The ga phase's batched search over the ranks: the first
    population's scores gathered from both blocks, then the search from
    Rng(GA_SEED) with ``mesh=``, timed after a warm-up."""
    torch.cuda.reset_peak_memory_stats(mesh.device)
    dev = mesh.device
    params = seeded_weights(sg2.init_generator(
        adapt_g_config(), torch.Generator().manual_seed(0), dev))
    e = ga_entry(dev, eval_mode="batched", generations=GA_GENERATIONS,
                 g_params=params)
    cfg = e.cfg
    rows = mesh_lib.share_rows(cfg.population, mesh.world_size, mesh.rank)
    with torch.no_grad():
        scores = mesh.gather(ga_search.eval_batched(
            cfg, e.g_cfg, params, e.fitness_fn, population.to(dev)[rows],
            z.to(dev)), rows, cfg.population)
    ga_search.evolve_directions(Rng(GA_SEED), e.g_cfg, params, e.fitness_fn,
                                dataclasses.replace(cfg, generations=0),
                                mesh=mesh)
    fmc.fused_modconv3x3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, hist = ga_search.evolve_directions(
        Rng(GA_SEED), e.g_cfg, params, e.fitness_fn, cfg, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"best": best, "history": hist, "scores": scores.cpu().numpy(),
            "rate": cfg.population * (cfg.generations + 1) / wall,
            "launches": fmc.fused_modconv3x3.launches,
            "peak": torch.cuda.max_memory_allocated(dev)}


def _resume_build(mesh):
    return dp_train_entry(mesh, batch=DIST_RESUME_BATCH, ada_p=0.2)


def dist_two_rank(mesh, data, out_dir, population, z):
    """One of two ranks sharing the card over gloo: (4) the GA first, while
    neither rank's allocator holds anything (its batched generation is the
    largest peak), then (2b) the fp32 step against the one-process step,
    (3) the loop, (2a) the bf16 step's time, (5) the resume cycle (parallel/dryrun.py's full / pre / resume at
    FFHQ-1024, global batch DIST_RESUME_BATCH, the "none" variant)."""
    _dist_settings()
    out = {"ga": _dist_ga(mesh, population, z)}
    torch.cuda.empty_cache()
    out["step"] = _dist_check(mesh)
    torch.cuda.empty_cache()
    out["loop"] = _dist_loop(mesh, data, out_dir)
    torch.cuda.empty_cache()
    out["step"].update(_dist_timing(mesh))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["resume"] = dryrun.resume_cycle_rank(mesh, out_dir, _resume_build,
                                             "none")
    out["resume_s"] = time.perf_counter() - t0
    return out


def dist_phase(tmp, data, card, train_seconds, ga_run):
    """Data parallelism on the card: (1) an NCCL world of one, bit-equal to
    the in-process step; (2)-(5) two ranks on the one card over gloo (asked
    for: NCCL refuses two ranks on one card), the step against the
    one-process step, the loop writing from rank 0 only, the GA with
    ``mesh=`` and the bit-equal resume cycle.  Returns rank 0's fused
    launches."""
    phase("dist")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    g_cfg = train_configs(TRAIN_BATCH)[0]
    t0 = time.perf_counter()
    (one,) = mesh_lib.spawn(dist_one_rank, 1, backend="nccl",
                            timeout=DIST_TIMEOUT, limit=DIST_TIMEOUT)
    wall1 = time.perf_counter() - t0
    want1 = expected_launches(g_cfg, 8) * (TRAIN_BATCH // 8)
    for v in DIST_VARIANTS:
        dp, ref = one["dp"][v], one["ref"][v]
        print(f"dist NCCL world of one, {v}: state digest "
              f"{dp['state'][:16]} through the group, {ref['state'][:16]} "
              f"in process; fused launches {dp['launches']} / "
              f"{ref['launches']} (expected {want1})", flush=True)
        if dp["state"] != ref["state"] or dp["launches"] != want1:
            raise AssertionError(f"dist world of one {v}: not the in-process "
                                 f"step")
    print(f"dist NCCL world of one: none {one['dp_s']:.4f} s/step through "
          f"the process group against {one['ref_s']:.4f} in process "
          f"(deterministic algorithms, TF32 off; the train phase, default "
          f"algorithms: {train_seconds['none']:.4f}); spawn and run "
          f"{wall1:.1f} s, on {card}", flush=True)

    torch.cuda.empty_cache()
    # The two ranks' allocators share the card: segments that grow in place
    # leave less of it reserved and unused.
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        ranks = mesh_lib.spawn(
            dist_two_rank, 2, backend="gloo", devices="cuda:0",
            timeout=DIST_TIMEOUT, limit=DIST_TIMEOUT,
            args=(data, tmp, ga_run["population"].cpu(), ga_run["z"].cpu()))
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    wall2 = time.perf_counter() - t0
    want2 = expected_launches(g_cfg, 8) * (TRAIN_BATCH // 2 // 8)
    want_c = expected_launches(g_cfg, DIST_CHECK_BATCH_GPU) * (
        DIST_CHECK_BATCH // 2 // DIST_CHECK_BATCH_GPU)
    for r, out in enumerate(ranks):
        st = out["step"]
        print(f"dist gloo rank {r}/2 on cuda:0, bf16 at global batch "
              f"{TRAIN_BATCH}: none fused launches {st['launches']} "
              f"(expected {want2}), {st['none_s']:.4f} s/step warm, "
              f"gradient all_reduce "
              f"{st['allreduce_ms']:.2f} ms for {st['allreduce_mib']:.1f} MiB,"
              f" peak {st['peak'] / 2 ** 30:.3f} GiB; fp32 check at global "
              f"batch {DIST_CHECK_BATCH}: launches {st['check_launches']} "
              f"(expected {want_c} each), s "
              f"{ {v: round(x, 4) for v, x in st['check_s'].items()} }; on "
              f"{card}", flush=True)
        if st["launches"] != want2 or any(
                n != want_c for n in st["check_launches"].values()):
            raise AssertionError(f"dist rank {r}: launches")
    st = ranks[0]["step"]
    bounds = ", ".join(f"{k} {v:.4g}" for k, v in DIST_BOUNDS.items())
    for v in DIST_VARIANTS:
        c = st["compare"][v]
        print(f"dist 2 ranks vs one process, fp32, {v}: {_dist_reading(c)} "
              f"(bounds {bounds}; ada_p equal); one process "
              f"{st['ref_s'][v]:.4f} s, peak {st['ref_peak'] / 2 ** 30:.3f} "
              f"GiB", flush=True)
        if _dist_breaks(c, v):
            raise AssertionError(f"dist {v}: two ranks are not the "
                                 f"one-process step: {_dist_breaks(c, v)}")
    for name, c in st["faults"].items():
        v = DIST_FAULTS[name][1]
        broken = _dist_breaks(c, v)
        print(f"dist planted fault, {name} ({v}): {_dist_reading(c)}; past "
              f"its bounds: {broken}", flush=True)
        if not broken:
            raise AssertionError(f"dist: the bounds do not fail the planted "
                                 f"fault {name}")

    loops = [out["loop"] for out in ranks]
    snaps = [f for f in loops[0]["files"] if f.startswith("network-snapshot")]
    want_l = expected_launches(g_cfg, 8) * loops[0]["rounds"] * (
        DIST_LOOP_BATCHES)
    for r, lp in enumerate(loops):
        print(f"dist loop rank {r}: {lp['batches']} batches by {lp['taken']},"
              f" waited {lp['wait']:.4f} s of {lp['wall']:.2f} s; fused "
              f"launches {lp['launches']} (expected {want_l}); files "
              f"{lp['files']}; peak {lp['peak'] / 2 ** 30:.3f} GiB",
              flush=True)
    if (loops[1]["files"] or len(snaps) != 1 or len(loops[0]["stats"]) != 1
            or any(lp["launches"] != want_l or lp["cur_nimg"] != LOOP_BATCH
                   * DIST_LOOP_BATCHES for lp in loops)):
        raise AssertionError("dist loop: files, snapshot or launches")
    torch.cuda.empty_cache()
    run = train_cli.build_run(LOOP_RES, batch=LOOP_BATCH, n_devices=2,
                              snap=1, seed=0)
    ref_dir = os.path.join(tmp, "dist_ref")
    torch.backends.cudnn.allow_tf32 = True
    loop_lib.training_loop(
        _dist_loop_config(run, ref_dir, None), run.train_cfg, run.g_cfg,
        run.d_cfg, train_cli.open_dataset(data, random_seed=0)[0],
        augment_cfg=run.augment_cfg, reg_remat=run.reg_remat, device=DEVICE)
    with open(os.path.join(ref_dir, "stats.jsonl")) as f:
        want_stats = json.loads(f.readline())
    got = loops[0]["stats"][0]
    diffs = {k: abs(got[k] - want_stats[k]) for k in want_stats
             if k.startswith("Loss/")}
    print(f"dist loop stats.jsonl, two ranks vs one process: "
          f"Loss/signs/real {got['Loss/signs/real']:.5f} / "
          f"{want_stats['Loss/signs/real']:.5f}; |diff| by metric "
          f"{ {k: round(v, 6) for k, v in diffs.items()} }", flush=True)
    # signs/real: a mean of +-1 over 32 images a batch; one image whose
    # logit sits at 0 flips it by 1/16 in a batch, 1/64 over four.
    if diffs["Loss/signs/real"] > 1 / 64 + 1e-6:
        raise AssertionError("dist loop: Loss/signs/real differs")

    gas = [out["ga"] for out in ranks]
    if not all(np.array_equal(g["history"], gas[0]["history"])
               and np.array_equal(g["best"], gas[0]["best"]) for g in gas):
        raise AssertionError("dist ga: the ranks disagree")
    score_err = float(np.abs(gas[0]["scores"] - ga_run["scores"]).max())
    hist_err = float(np.abs(gas[0]["history"] - ga_run["history"]).max())
    best_err = float(np.abs(gas[0]["best"] - ga_run["best"]).max())
    gaps = np.diff(np.sort(ga_run["scores"]))
    print(f"dist ga, 2 ranks vs the ga phase's batched run: first "
          f"population's scores max|diff| {score_err:.4g}, history "
          f"{hist_err:.4g} (bound {GA_SCORE_TOL:.4g}), best direction "
          f"{best_err:.4g} (bound 1e-4); nearest two scores "
          f"{float(gaps.min()):.4g} apart; {gas[0]['rate']:.3f} candidates/s "
          f"with two ranks on one card (one process: {ga_run['rate']:.3f}); "
          f"fused launches {[g['launches'] for g in gas]}; peak "
          f"{[round(g['peak'] / 2 ** 30, 3) for g in gas]} GiB", flush=True)
    if score_err > GA_SCORE_TOL:
        raise AssertionError("dist ga: scores disagree")
    if not (hist_err <= GA_SCORE_TOL and best_err <= 1e-4):
        if float(gaps.min()) > score_err:
            raise AssertionError("dist ga: the search differs though no "
                                 "two scores are within the scores' error")
        print("dist ga: two candidates' scores lie closer than the scores' "
              "error, so the searches may part: the scores are held "
              "instead", flush=True)

    digest = dryrun.check_resume_cycle([out["resume"] for out in ranks])
    print(f"dist resume cycle (global batch {DIST_RESUME_BATCH}, 4 steps "
          f"against 2 + save on rank 0 + restore on both + 2): bit-equal on "
          f"both ranks, digest {digest[:16]}, "
          f"{ranks[0]['resume_s']:.1f} s; the two-rank run {wall2:.1f} s, "
          f"on {card}", flush=True)
    return (st["launches"] + sum(st["check_launches"].values())
            + loops[0]["launches"] + gas[0]["launches"])


# ----------------------------------------------------------------------------
# spatial: spatial (height) sharding over torch.distributed ranks
# (parallel/spatial.py)


@dataclasses.dataclass(frozen=True)
class SpatialPlan:
    """The spatial phase's sizes.  Its ranks are spawned and re-import this
    script, so the sizes travel as this argument: the CLI's G and D at
    ``res``^2 (``channel_base`` None: full width), the forward check's
    batch and min_res values (a), the fp32 step check's global batch (b),
    the bf16 arms' global batch and min_res values (c), the loop's batch
    and batches (d), and the card (``cuda:0``) or 'cpu'."""
    res: int = 1024
    channel_base: Optional[int] = None
    fwd_batch: int = 4
    fwd_min_res: tuple = (256, 64)
    check_batch: int = 4
    arm_batch: int = 8
    arm_min_res: tuple = (256, 128)
    loop_batch: int = 8
    loop_batches: int = 2
    device: str = "cuda:0"


SPATIAL = SpatialPlan()
# The checks of the phase against one process, each by its own bound: 16
# times the first fp32 reading on the H100 (PERF.md §6), rounded up
# to a power of two, as DIST_BOUNDS.  "forward": the gathered fp32 image's
# max |difference| from the one-process forward at batch 4 (2.67e-5, the
# larger of min_res 256 and 64); the step's quantities as _compare_grads
# reads them, the three variants in fp32 at global batch
# SPATIAL.check_batch, learning rate 0, with the GA Dmain round: G's
# gradient relative L2 by phase (Gmain 1.31e-4: cuDNN's fp32 algorithms
# for a window's shape are not the whole map's, and G's cancelling sums,
# the noise strengths, move most; Greg 3.90e-4), D's (2.96e-5), the loss
# metrics (main 1.52e-7, regularizers 1.13e-4), pl_mean (5.55e-5) and w_avg
# (read 0: the bound stands at 2^-20).  Planted faults that must fail them
# (SPATIAL_FAULTS): halo rows zero-filled (forward and "none") and the
# gradients divided by the world size ("none").
SPATIAL_BOUNDS = {"forward": 2 ** -11, "G main": 2 ** -8, "G reg": 2 ** -7,
                  "D": 2 ** -11, "loss main": 2 ** -18, "loss reg": 2 ** -9,
                  "pl_mean": 2 ** -10, "w_avg": 2 ** -20}


def _fault_zero_halo():
    """The halo rows a window takes from its neighbours zero-filled (the
    exchange itself still runs)."""
    orig = spatial_lib.RowLayout._halo

    def zero_halo(self, x, k):
        w = orig(self, x, k).clone()
        w[..., :k, :] = 0
        w[..., w.shape[-2] - k:, :] = 0
        return w
    return spatial_lib.RowLayout, "_halo", zero_halo


def _fault_divided_bucket():
    """Every phase's gradients divided by the world size before Adam, as
    the data-parallel mean would divide them."""
    orig = ts._scrub

    def divided(grads):
        return {k: g / 2 for k, g in orig(grads).items()}
    return ts, "_scrub", divided


SPATIAL_FAULTS = {"halo rows zero-filled": _fault_zero_halo,
                  "gradients divided by the world size":
                      _fault_divided_bucket}


@contextlib.contextmanager
def _planted(plant):
    owner, attr, fn = plant()
    orig = getattr(owner, attr)
    setattr(owner, attr, fn)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync_dev(device):
    if _on_card(device):
        torch.cuda.synchronize(device)


def _reset_peak(device):
    if _on_card(device):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if _on_card(device) else 0


class _Collectives:
    """Counts the mesh's all_reduces (data parallelism's and spatial
    sharding's) and the bytes a rank hands to them."""

    def __init__(self):
        self.calls = self.bytes = 0

    @contextlib.contextmanager
    def counting(self):
        orig = mesh_lib.Mesh.all_reduce_

        def counted(mesh, t):
            if mesh.sharded:
                self.calls += 1
                self.bytes += t.numel() * t.element_size()
            return orig(mesh, t)
        mesh_lib.Mesh.all_reduce_ = counted
        try:
            yield self
        finally:
            mesh_lib.Mesh.all_reduce_ = orig


def _spatial_g(plan: SpatialPlan, fp32: bool):
    """The CLI's G (FFHQ-1024 at full width, bf16 in its 4 highest
    resolutions, conv_clamp 256, the packed last block, the fused level),
    all in fp32 with ``fp32``."""
    return train_run(plan.fwd_batch, plan.res, plan.channel_base,
                     fp32=fp32).g_cfg


def _spatial_forward(mesh, plan: SpatialPlan):
    """(a) spatial_synthesis_fn at batch plan.fwd_batch from seeded weights:
    in fp32 at each min_res (the gathered image, the rank's fused launches
    and exchanges), with zero-filled halos at the first, and in bf16 at the
    first; rank 0 then runs the one-process forwards while rank 1 waits."""
    dev = mesh.device
    out = {"fp32": {}, "launches": {}, "exchanges": {}}
    z = torch.randn((plan.fwd_batch, 512), generator=torch.Generator()
                    .manual_seed(3)).to(dev)
    runs = {}
    for fp32 in (True, False):
        g_cfg = _spatial_g(plan, fp32)
        params = seeded_weights(sg2.init_generator(
            g_cfg, torch.Generator().manual_seed(0), dev))
        wsb = sg2.mapping_apply(g_cfg.mapping, params["mapping"], z)
        runs[fp32] = (g_cfg, params, wsb)
        min_res = plan.fwd_min_res if fp32 else plan.fwd_min_res[:1]
        for m in min_res:
            fn = spatial_lib.spatial_synthesis_fn(g_cfg, mesh, min_res=m)
            fmc.fused_modconv3x3.launches = 0
            spatial_lib.reset_stats()
            with torch.no_grad():
                img = spatial_lib.gather_rows(fn(params, wsb), mesh,
                                              plan.res)
            _sync_dev(dev)
            key = m if fp32 else "bf16"
            out["launches"][key] = fmc.fused_modconv3x3.launches
            out["exchanges"][key] = (spatial_lib.STATS["exchanges"],
                                     spatial_lib.STATS["bytes"])
            if fp32:
                out["fp32"][m] = img.cpu()
            else:
                out["bf16"] = img.cpu()
            if fp32 and m == plan.fwd_min_res[0]:
                with _planted(_fault_zero_halo), torch.no_grad():
                    out["fault"] = spatial_lib.gather_rows(
                        fn(params, wsb), mesh, plan.res).cpu()
        del params
    mesh.barrier()
    if mesh.rank == 0:
        for fp32, (g_cfg, params, wsb) in runs.items():
            with torch.no_grad():
                out["one_fp32" if fp32 else "one_bf16"] = sg2.synthesis_apply(
                    g_cfg.synthesis, params["synthesis"], wsb).cpu()
    del runs
    mesh.barrier()
    return out


def _spatial_check(mesh, plan: SpatialPlan):
    """(b) The three variants in fp32 at global batch plan.check_batch and
    learning rate 0 with the GA Dmain round, min_res 256 (the CLI's plan for
    two devices), each rank's gradients kept, each planted fault in "none";
    rank 0 then runs the one-process step of the same plan while rank 1
    waits, and compares."""
    check = dict(batch=plan.check_batch, ada_p=0.2, lrate=0.0, fp32=True,
                 ga_threshold=0.5, img_resolution=plan.res,
                 channel_base=plan.channel_base)
    steps, state, inputs = spatial_train_entry(
        mesh, min_res=plan.fwd_min_res[0], **check)
    runs = dryrun.run_variants(mesh, steps, state, inputs, DIST_VARIANTS,
                               keep=_grad_leaves)
    faults = {}
    for name, plant in SPATIAL_FAULTS.items():
        with _planted(plant):
            faults[name] = dryrun.run_variants(
                mesh, steps, state, inputs, ("none",),
                keep=_grad_leaves)["none"]
    out = {"launches": {v: r["launches"] for v, r in runs.items()},
           "s": {v: r["s"] for v, r in runs.items()}}
    del steps, state, inputs
    mesh.barrier()
    if mesh.rank == 0:
        steps, state, inputs = train_entry(mesh.device, n_devices=2, **check)
        ref = dryrun.run_variants(None, steps, state, inputs, DIST_VARIANTS,
                                  keep=_grad_leaves)
        out["ref_s"] = {v: r["s"] for v, r in ref.items()}
        out["compare"] = {v: _compare_grads(
            runs[v]["state"], ref[v]["state"], runs[v]["metrics"],
            ref[v]["metrics"]) for v in DIST_VARIANTS}
        out["faults"] = {name: _compare_grads(
            f["state"], ref["none"]["state"], f["metrics"],
            ref["none"]["metrics"]) for name, f in faults.items()}
        del steps, state, inputs, ref
    mesh.barrier()
    return out


def _spatial_arm(mesh, plan: SpatialPlan, build):
    """One bf16 "none" arm: built, run once, then timed; its s/step, the
    rank's peak memory, its fused launches and the mesh's all_reduces of
    the timed step."""
    dev = mesh.device
    _reset_peak(dev)
    steps, state, inputs = build()
    s = copy.deepcopy(state)
    s, _ = steps["none"](s, *inputs)
    del s
    counter = _Collectives()
    s = copy.deepcopy(state)
    fmc.fused_modconv3x3.launches = 0
    _sync_dev(dev)
    with counter.counting():
        t0 = time.perf_counter()
        s, metrics = steps["none"](s, *inputs)
        _sync_dev(dev)
        sec = time.perf_counter() - t0
    out = {"s": sec, "peak": _peak(dev), "calls": counter.calls,
           "bytes": counter.bytes, "launches": fmc.fused_modconv3x3.launches,
           "finite": all(bool(torch.isfinite(v).all())
                         for v in metrics.values())}
    del steps, state, inputs, s
    _reset_peak(dev)
    return out


def _spatial_arms(mesh, plan: SpatialPlan):
    """(c) The bf16 "none" step at global batch plan.arm_batch: two-rank
    data parallelism, then spatial sharding at each of plan.arm_min_res,
    then the one process on rank 0 while rank 1 waits."""
    size = dict(batch=plan.arm_batch, ada_p=0.2, img_resolution=plan.res,
                channel_base=plan.channel_base)
    arms = {"data parallel": _spatial_arm(
        mesh, plan, lambda: dp_train_entry(mesh, **size))}
    for m in plan.arm_min_res:
        arms[f"spatial {m}"] = _spatial_arm(
            mesh, plan, lambda m=m: spatial_train_entry(mesh, min_res=m,
                                                        **size))
    mesh.barrier()
    if mesh.rank == 0:
        arms["one process"] = _spatial_arm(
            mesh, plan, lambda: train_entry(mesh.device, **size))
    mesh.barrier()
    return arms


def _spatial_loop(mesh, plan: SpatialPlan, data, out_dir):
    """(d) training_loop with spatial_shard_min_res (the CLI's plan for two
    devices at plan.loop_batch) on ``data`` for plan.loop_batches batches,
    each rank in a run directory of its own: the files each wrote, its
    stats lines and fused launches (the replica check runs before the
    snapshot)."""
    run = train_run(plan.loop_batch, plan.res, plan.channel_base,
                    n_devices=2, snap=1, seed=0,
                    spatial_shard_min_res=plan.fwd_min_res[0])
    kimg = plan.loop_batches * plan.loop_batch / 1000
    run_dir = os.path.join(out_dir, "spatial_run", f"rank{mesh.rank}")
    loop_cfg = dataclasses.replace(
        run.loop_cfg, run_dir=run_dir, total_kimg=kimg, kimg_per_tick=kimg,
        image_snapshot_ticks=None, network_snapshot_ticks=1,
        log_param_histograms=False)
    fmc.fused_modconv3x3.launches = 0
    t0 = time.perf_counter()
    state = loop_lib.training_loop(
        loop_cfg, run.train_cfg, run.g_cfg, run.d_cfg,
        train_cli.open_dataset(data, random_seed=0)[0],
        augment_cfg=run.augment_cfg, reg_remat=run.reg_remat,
        spatial_shard_min_res=run.spatial_shard_min_res, mesh=mesh)
    _sync_dev(mesh.device)
    files = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []
    stats = []
    if "stats.jsonl" in files:
        with open(os.path.join(run_dir, "stats.jsonl")) as f:
            stats = [json.loads(ln) for ln in f if ln.strip()]
    return {"files": files, "stats": stats, "cur_nimg": state.cur_nimg,
            "launches": fmc.fused_modconv3x3.launches,
            "wall": time.perf_counter() - t0}


def spatial_rank(mesh, plan: SpatialPlan, data, out_dir):
    """One of two ranks sharing the card over gloo: (a)-(d)."""
    _dist_settings()
    out = {"forward": _spatial_forward(mesh, plan)}
    out["check"] = _spatial_check(mesh, plan)
    out["arms"] = _spatial_arms(mesh, plan)
    out["loop"] = _spatial_loop(mesh, plan, data, out_dir)
    return out


def _spatial_breaks(c, variant: str) -> list:
    """The quantities of a step comparison past their SPATIAL_BOUNDS (G's
    by its last phase), and a changed ada_p."""
    got = {"G main" if variant == "none" else "G reg": c["nets"]["G"][0],
           "D": c["nets"]["D"][0], "loss main": c["loss"]["main"],
           "loss reg": c["loss"]["reg"], "pl_mean": c["pl_mean"],
           "w_avg": c["w_avg"]}
    bad = [k for k, v in got.items() if not v <= SPATIAL_BOUNDS[k]]
    return bad + (["ada_p"] if c["ada_p"] != 0 else [])


def spatial_phase(tmp, data, card, plan: SpatialPlan = SPATIAL):
    """Spatial sharding on the card, two gloo ranks sharing it (NCCL refuses
    that), deterministic algorithms and TF32 off: (a) the
    sharded forward against one process in fp32, a planted fault and the
    bf16 difference; (b) the fp32 step against one process (SPATIAL_BOUNDS,
    the ranks bit-equal) and two planted faults; (c) the bf16 "none" step
    in four arms (one process, data parallelism, spatial at two min_res):
    s/step, peak memory a rank, all_reduces and bytes a step; (d) the loop,
    writing from rank 0.  Returns rank 0's fused launches."""
    phase("spatial")
    on_card = _on_card(plan.device)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        ranks = mesh_lib.spawn(spatial_rank, 2, backend="gloo",
                               devices=plan.device, timeout=DIST_TIMEOUT,
                               limit=DIST_TIMEOUT,
                               args=(plan, data, tmp))
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    wall = time.perf_counter() - t0

    fwd = [r["forward"] for r in ranks]
    first = plan.fwd_min_res[0]
    for m in plan.fwd_min_res:
        if not torch.equal(fwd[0]["fp32"][m], fwd[1]["fp32"][m]):
            raise AssertionError(f"spatial forward {m}: the ranks' gathered "
                                 f"images differ")
    errs = {m: float((fwd[0]["fp32"][m] - fwd[0]["one_fp32"]).abs().max())
            for m in plan.fwd_min_res}
    fault = float((fwd[0]["fault"] - fwd[0]["one_fp32"]).abs().max())
    bf16 = float((fwd[0]["bf16"] - fwd[0]["one_bf16"]).abs().max())
    print(f"spatial forward, fp32, batch {plan.fwd_batch}, two ranks vs one "
          f"process: max|diff| by min_res { {m: float(f'{e:.4g}') for m, e in errs.items()} } "
          f"(bound {SPATIAL_BOUNDS['forward']:.4g}); zero-filled halos at "
          f"{first}: {fault:.4g}; bf16 at {first}: {bf16:.4g}; fused "
          f"launches a rank {[f['launches'] for f in fwd]}; all_reduces and "
          f"bytes a forward {fwd[0]['exchanges']}; on {card}", flush=True)
    if any(e > SPATIAL_BOUNDS["forward"] for e in errs.values()):
        raise AssertionError(f"spatial forward: {errs} past the bound")
    if not fault > SPATIAL_BOUNDS["forward"]:
        raise AssertionError("spatial forward: the bound does not fail "
                             "zero-filled halos")
    if on_card and not all(f["launches"][first] > 0 for f in fwd):
        raise AssertionError(f"spatial forward: no fused launch at min_res "
                             f"{first}")

    st = ranks[0]["check"]
    bounds = ", ".join(f"{k} {v:.4g}" for k, v in SPATIAL_BOUNDS.items())
    for v in DIST_VARIANTS:
        c = st["compare"][v]
        print(f"spatial 2 ranks vs one process, fp32, {v} (min_res {first},"
              f" batch {plan.check_batch}): {_dist_reading(c)} (bounds "
              f"{bounds}; ada_p equal); s {st['s'][v]:.4f} a rank, one "
              f"process {st['ref_s'][v]:.4f}; fused launches "
              f"{st['launches'][v]}", flush=True)
        if _spatial_breaks(c, v):
            raise AssertionError(f"spatial {v}: two ranks are not the "
                                 f"one-process step: {_spatial_breaks(c, v)}")
    for name, c in st["faults"].items():
        broken = _spatial_breaks(c, "none")
        print(f"spatial planted fault, {name} (none): {_dist_reading(c)}; "
              f"past its bounds: {broken}", flush=True)
        if not broken:
            raise AssertionError(f"spatial: the bounds do not fail the "
                                 f"planted fault {name}")

    arms, peaks1 = ranks[0]["arms"], ranks[1]["arms"]
    for name in ("one process", "data parallel") + tuple(
            f"spatial {m}" for m in plan.arm_min_res):
        a = arms[name]
        other = ("" if name == "one process" else
                 f" (rank 1: {peaks1[name]['peak'] / 2 ** 30:.3f} GiB, "
                 f"{peaks1[name]['s']:.4f} s)")
        print(f"spatial arm {name}, bf16 none at global batch "
              f"{plan.arm_batch}: {a['s']:.4f} s/step, peak "
              f"{a['peak'] / 2 ** 30:.3f} GiB a rank{other}, "
              f"{a['calls']} all_reduces of {a['bytes'] / 2 ** 20:.1f} MiB a "
              f"step, fused launches {a['launches']}; on {card}", flush=True)
        if not a["finite"]:
            raise AssertionError(f"spatial arm {name}: non-finite metrics")
    one_peak = arms["one process"]["peak"]
    for m in plan.arm_min_res:
        for r in ranks:
            if on_card and not r["arms"][f"spatial {m}"]["peak"] < one_peak:
                raise AssertionError(
                    f"spatial {m}: a rank's peak is not below the one "
                    f"process's: the maps were not sharded")

    loops = [r["loop"] for r in ranks]
    for r, lp in enumerate(loops):
        print(f"spatial loop rank {r} (min_res {first}, {plan.loop_batches} "
              f"batches of {plan.loop_batch}): files {lp['files']}, stats "
              f"lines {len(lp['stats'])}, fused launches {lp['launches']}, "
              f"{lp['wall']:.2f} s", flush=True)
    snaps = [f for f in loops[0]["files"] if f.startswith("network-snapshot")]
    if (loops[1]["files"] or len(snaps) != 1 or len(loops[0]["stats"]) != 1
            or any(lp["cur_nimg"] != plan.loop_batch * plan.loop_batches
                   for lp in loops)):
        raise AssertionError("spatial loop: files, stats or images")
    print(f"spatial phase: two ranks {wall:.1f} s, on {card}", flush=True)
    return (sum(fwd[0]["launches"].values()) + sum(st["launches"].values())
            + sum(a["launches"] for k, a in ranks[0]["arms"].items()
                  if k != "one process") + loops[0]["launches"])


def main():
    card, peaks = device_phase()
    build_phase()
    k = kernel_phase(peaks)
    params, launches = main_phase(card)
    cli_launches = cli_phase(params)
    del params
    torch.cuda.empty_cache()
    keep = {}
    train_launches, seconds, peak_mem, sec_per_batch = train_phase(card, keep)
    torch.cuda.empty_cache()
    state_launches = state_phase(keep, card)
    del keep
    torch.cuda.empty_cache()
    tail_launches = tail_phase(card, seconds["none"])
    torch.cuda.empty_cache()
    warp_times = warp_phase(card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        snap, loop_launches, loop_sec_per_kimg, data = loop_phase(
            tmp, card, sec_per_batch / TRAIN_BATCH * 1000)
        torch.cuda.empty_cache()
        remat_launches = remat_phase(card)
        torch.cuda.empty_cache()
        cli_launches += cli_snapshot_phase(snap)
        torch.cuda.empty_cache()
        (fewshot_launches, fewshot_seconds, fewshot_mem,
         fewshot_sec_per_kimg) = fewshot_phase(tmp, snap, card)
        torch.cuda.empty_cache()
        adapt_launches, adapt_rate = adapt_phase(card)
        torch.cuda.empty_cache()
        im2im_launches, im2im_needs, im2im_rate = im2im_phase(card)
        torch.cuda.empty_cache()
        ga_launches, ga_run = ga_phase(tmp, card)
        torch.cuda.empty_cache()
        dist_launches = dist_phase(tmp, data, card, seconds, ga_run)
        del ga_run
        torch.cuda.empty_cache()
        spatial_launches = spatial_phase(tmp, data, card)
        torch.cuda.empty_cache()
        metrics_launches, ppl_launches = metrics_phase(tmp, snap, card)
        torch.cuda.empty_cache()
        inversion_launches, ii2s_needs = inversion_phase(tmp, card)
        torch.cuda.empty_cache()
    face_launches = face_phase(card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        examples_launches = examples_phase(tmp, card)
        torch.cuda.empty_cache()
        zoo_launches = zoo_phase(tmp, card)
    by_path = {"forward": launches, "cli": cli_launches,
               "train": train_launches, "loop": loop_launches,
               "remat": remat_launches, "adapt": adapt_launches,
               "fewshot": fewshot_launches, "im2im": im2im_launches,
               "ga": sum(ga_launches.values()), "metrics": metrics_launches,
               "inversion": inversion_launches, "face": face_launches,
               "state": state_launches, "tail": tail_launches,
               "examples": examples_launches, "zoo": zoo_launches,
               "dist": dist_launches, "spatial": spatial_launches}
    f32 = k["fp32"]
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
        bwd_max_rel_l2_err=k["bwd_max_rel_l2_err"],
        im2im_bwd_needs=[[int(f) for f in n] for n in im2im_needs],
        ii2s_bwd_needs=[[int(f) for f in n] for n in ii2s_needs],
        ga_launches_by_mode=ga_launches, fp32_launches=ppl_launches,
        fp32_ms=f32["ms"], fp32_fold_ms=f32["fold_ms"],
        fp32_plain_ms=f32["plain_ms"], fp32_bound_ms=f32["bound_ms"],
        fp32_bound_by=("operations" if f32["flop_ms"] >= f32["byte_ms"]
                       else "bytes"),
        fp32_library_ms=f32["library_ms"],
        fp32_max_abs_err=f32["max_abs_err"])]
    print(f"(kernel times: the launches of one batch-{BATCH} forward, "
          f"b128.conv1 + b256.conv1, on {card}; bwd_*: the level's composed "
          f"backward at the same shapes; train: s/step "
          f"{ {n: round(v, 4) for n, v in seconds.items()} }, peak GiB "
          f"{ {n: round(v / 2 ** 30, 3) for n, v in peak_mem.items()} }, "
          f"{sec_per_batch / TRAIN_BATCH * 1000:.4f} s/kimg; loop: "
          f"{loop_sec_per_kimg:.4f} s/kimg (PRs 4-10: "
          f"{LOOP_SEC_PER_KIMG_BEFORE}); ADA pipe ms (fwd, fwd+bwd) "
          f"{ {m: (round(v[0], 3), round(v[1], 3)) for m, v in warp_times.items()} }; "
          f"adapt: {adapt_rate:.4f} "
          f"steps/s; fewshot: s/step "
          f"{ {n: round(v, 4) for n, v in fewshot_seconds.items()} }, peak "
          f"GiB { {n: round(v / 2 ** 30, 3) for n, v in fewshot_mem.items()} }, "
          f"{fewshot_sec_per_kimg:.4f} s/kimg; im2im: DiFa "
          f"{im2im_rate:.4f} steps/s; im2im_bwd_needs: the level's backward "
          f"flags (dx, dW, dstyles, ddcoefs, dnoise, dbias) asked for by the "
          f"projector and adapt commands, ii2s_bwd_needs by II2S; fp32_*: the same two levels in "
          f"fp32, the route of the force_fp32 G that PPL samples, whose "
          f"launches on the metrics path fp32_launches counts)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
