"""Training cells: the port's training loop (``train/loop.py``) as
``cli/train.py`` configures it, on a seeded dataset zip and the
benchmark's seeded weights, measured over whole cycles of the
lazy-regularization schedule.

Set-up writes the zip, draws G and D from the seed and writes them as a
network snapshot, which the loop resumes from (``resume_from``), builds
the run with the command's own ``build_run`` and starts the loop.  Its
first batches are the loop's own: the first three are recorded for the
check (the real images, the latents and step key each step got, the
losses, D's per-sample outputs in the first, the Adam moments after it,
each leaf's change after the third), and the window opens at the first
tick after every step variant has run (``warm_batches``).  It closes at
the first tick at least the window's seconds later that ends a whole
number of ``cycle_batches`` (Dreg's interval), so that every window holds
the schedule's mix of variants.  Traced, the window opens at the first
Dreg batch after the warm batches and closes at the first tick
(``tick_batches``) after ``trace_seconds``: one tick that runs Dreg, Greg
and "none" steps (reducing a profile of a whole cycle at 1024^2 takes
minutes).  After the loop the reference
follows the same three batches from the same weights and inputs in
float32 and the two are compared (``reference/compare.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import data, flops, harness, instrument
from portbench.reference import compare, train_ref
from portbench.reference.frozen.utils.rng import Rng


def build(run: harness.Run, zip_path: str, weights_path: str):
    """The command's run for the cell, the dataset, and the loop config."""
    from gagan_tpu_torch.cli import train as train_cli

    c, t = run.config, run.traffic
    dataset, _line = train_cli.open_dataset(
        zip_path, use_labels=False, xflip=False, max_size=None,
        random_seed=0)
    opts = dict(t.get("options", {}))
    plan = train_cli.build_run(
        dataset.resolution, dataset.num_channels, 0, cfg=c["cli_cfg"],
        batch=t["batch"], aug="ada", augpipe=t["augpipe"],
        target=t["ada_target"], **opts)
    if "plan" in run.overrides:          # tiny CPU runs of the tests
        plan = run.overrides["plan"](plan)
    g, d, tc = plan.g_cfg, plan.d_cfg, plan.train_cfg
    stated = dict(z_dim=g.z_dim, w_dim=g.w_dim,
                  mapping_layers=g.mapping.num_layers,
                  channel_base=g.synthesis.channel_base,
                  channel_max=g.synthesis.channel_max,
                  num_fp16_res=g.synthesis.num_fp16_res,
                  conv_clamp=g.synthesis.conv_clamp,
                  mbstd_group_size=d.mbstd_group_size,
                  r1_gamma=tc.loss.r1_gamma, ema_kimg=tc.ema_kimg,
                  img_resolution=g.img_resolution)
    for k, v in stated.items():
        if c[k] != v:
            raise harness.SetupError(f"the command's plan has {k}={v}, the "
                                     f"configuration states {c[k]}")
    if list(plan.accum_rounds[:1]) + [plan.accum_rounds[1] or
                                      plan.accum_rounds[0],
                                      plan.accum_rounds[2] or
                                      plan.accum_rounds[0]] != t["rounds"]:
        raise harness.SetupError(f"the command's rounds {plan.accum_rounds} "
                                 f"differ from the mix's {t['rounds']}")
    if bool(plan.reg_remat) != bool(t.get("reg_remat")):
        raise harness.SetupError("the command's R1 remat differs from the mix")
    loop_cfg = dataclasses.replace(
        plan.loop_cfg, run_dir=os.path.join(os.path.dirname(zip_path), "run"),
        resume_from=weights_path,
        total_kimg=1e9, kimg_per_tick=t["batch"] * t["tick_batches"] / 1000,
        image_snapshot_ticks=None, network_snapshot_ticks=None,
        random_seed=run.seed % (2 ** 31), initial_ada_p=t["initial_ada_p"],
        log_param_histograms=False)
    return plan, dataset, loop_cfg


class Capture:
    """The loop's first batches, recorded through a wrapper around the
    step variants that ``training_loop`` builds."""

    def __init__(self, n: int = 3):
        self.n, self.batches = n, 0
        self.reals: List[torch.Tensor] = []
        self.inputs: List[Any] = []
        self.losses: List[Dict[str, float]] = []
        self.first: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self._before = None
        self.offsets_on = False
        self.d_logits: Dict[str, Any] = {}

    def wrap(self, make_fused_step):
        from gagan_tpu_torch.models import stylegan2 as sg2

        def make(*args, **kwargs):
            step = make_fused_step(*args, **kwargs)

            def tracked(state, real_img, real_c, z, gen_c, key, mesh=None):
                i = self.batches
                if i == 0:
                    self.offsets_on = state.offsets is not None
                    self._before = train_ref.snapshot(state)
                if i < self.n:
                    self.reals.append(torch.round(
                        (real_img.detach().float() + 1.0) * 127.5)
                        .clamp(0, 255).to(torch.uint8).cpu())
                    self.inputs.append((z.detach().float().cpu().clone(),
                                        int(key.seed)))
                with train_ref.d_outputs(sg2, self.d_logits, i == 0):
                    state, metrics = step(state, real_img, real_c, z, gen_c,
                                          key, mesh)
                if i < self.n:
                    self.losses.append(train_ref.losses(metrics))
                if i == 0:
                    self.first = train_ref.leaf_norms_after_first(
                        state, self.offsets_on)
                if i == self.n - 1:
                    self.change = train_ref.change_norms(self._before, state)
                    self._before = None
                self.batches += 1
                return state, metrics
            return tracked
        return make


def run(r: harness.Run) -> harness.Outcome:
    from gagan_tpu_torch.train import loop as loop_lib

    c, t = r.config, r.traffic
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        imgs = data.images(r.seed, t["images"], c["img_resolution"],
                           c["img_channels"])
        zip_path = data.write_zip(os.path.join(tmp, "data.zip"), imgs)
        r.mark("inputs")
        weights = train_ref.make_weights(c, t, r.seed)
        weights_path = train_ref.write_snapshot(
            os.path.join(tmp, "weights.npz"), weights)
        r.mark("weights")
        plan, dataset, loop_cfg = build(r, zip_path, weights_path)
        capture = Capture()
        levels = instrument.LevelCalls()
        window = dict(start=None, end=None)

        def abort() -> bool:
            n = capture.batches
            if window["start"] is None:
                # Traced, the window's one tick starts at a Dreg batch, so
                # that it runs every phase (Dreg and Greg, then "none").
                if n >= t["warm_batches"] and (
                        not r.trace or n % t["cycle_batches"] == 0):
                    window["start"] = n
                    levels.on = r.trace
                    r.start_window()
                return False
            done = n - window["start"]
            # Traced, the window is one tick (the first after its seconds).
            whole = t["tick_batches"] if r.trace else t["cycle_batches"]
            if (done % whole == 0
                    and time.time() - r.window_start >= r.window_seconds):
                r.end_window()
                levels.on = False
                window["end"] = n
                return True
            return False

        loop_cfg = dataclasses.replace(loop_cfg, abort_fn=abort)
        with instrument.wrap_attr(loop_lib.ts, "make_fused_step",
                                  capture.wrap), levels.installed():
            state = loop_lib.training_loop(
                loop_cfg, plan.train_cfg, plan.g_cfg, plan.d_cfg, dataset,
                augment_cfg=plan.augment_cfg,
                parametrization=plan.parametrization,
                weight_parts=plan.parts, reg_remat=plan.reg_remat,
                device=r.device, rng=Rng(r.seed))
        dataset.close()
        r.reduce_trace()
        del state
        gc.collect()
        if r.on_cuda:
            torch.cuda.empty_cache()

        batches = window["end"] - window["start"]
        kimg = batches * t["batch"] / 1000.0
        g_trains = "all" in plan.parts
        step_flops = [flops.train_step_flops(
            c, t["batch"], g_trains, greg=(i % 4 == 0), dreg=(i % 16 == 0))
            for i in range(window["start"], window["end"])]
        work = dict(steps=batches, model_flops=float(sum(step_flops)),
                    model_peak=harness.PEAK_BF16, level_calls=levels.calls)

        checks = check(r, imgs, weights, capture)
        return harness.Outcome(
            attempted=batches, failed=0,
            end_to_end={"train_s_per_kimg": r.window_s / kimg}, work=work,
            checks=checks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check(r: harness.Run, imgs: np.ndarray, weights, capture: Capture):
    """The program's first three batches against the reference's, from
    the same weights, on the same real images (each row the loader gave
    must be one of the dataset's images), latents and step keys."""
    t = r.traffic
    dataset = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous()
    index = {dataset[i].numpy().tobytes(): i for i in range(len(dataset))}
    unknown, reals = 0, []
    for batch in capture.reals:
        rows = []
        for row in batch:
            i = index.get(row.numpy().tobytes())
            unknown += i is None
            rows.append(row if i is None else dataset[i])
        reals.append(torch.stack(rows))
    ref = train_ref.follow(r.config, t, weights, capture.inputs, reals,
                           r.device)
    prog = dict(losses=capture.losses, first=capture.first,
                change=capture.change,
                logits=capture.d_logits.get("logits", []))
    limits = t["limits"]
    gaps = compare.judged(compare.train_checks(prog, ref), limits)
    checks = [harness.Check("rows_not_in_dataset", float(unknown), 0.0)]
    checks += [harness.Check(k, v, float(limits[k])) for k, v in gaps.items()]
    return checks
