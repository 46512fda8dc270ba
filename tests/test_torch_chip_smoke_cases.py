"""The kernel cases of chip_smoke.py, checked on the CPU: each lies inside
the fused kernel's predicate, together they reach the kernel's edges, and
the plain version runs at each case's shape (shrunk to one sample).  Also
the train phase's configuration (the JAX training CLI's 1024^2 plan) and
its control flow at a small size."""

import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gagan_tpu_torch.ops import fused_modconv as fmc
from gagan_tpu_torch.train import augment

torch.set_num_threads(2)

# The bf16 kernel's tile (csrc/fused_modconv.cu, namespace tc): 4 x 64
# pixels, 64-channel chunks of C_in, 128 output channels.
TILE_ROWS, TILE_COLS, CHANNEL_CHUNK, C_OUT_TILE = 4, 64, 64, 128
# The fp32 kernel's (namespace fp32): 4 x 64 pixels, 8-channel chunks, 128
# output channels.
FP32_TILE = (4, 64, 8, 128)

CASES = pytest.mark.parametrize("case", cs.KERNEL_CASES,
                                ids=[c.label for c in cs.KERNEL_CASES])


@CASES
def test_case_inside_predicate(case):
    assert fmc.supported_shape((case.n, case.c_in, case.h, case.w),
                               (case.c_out, case.c_in, 3, 3))


def test_cases_cover_the_kernel_edges():
    bf16 = [c for c in cs.KERNEL_CASES if c.dtype == torch.bfloat16]
    assert any(c.c_in % CHANNEL_CHUNK for c in bf16)         # partial chunk
    for dtype, (rows, cols, chunk, c_out_tile) in (
            (torch.bfloat16, (TILE_ROWS, TILE_COLS, CHANNEL_CHUNK,
                              C_OUT_TILE)),
            (torch.float32, FP32_TILE)):
        cases = [c for c in cs.KERNEL_CASES if c.dtype == dtype]
        assert any(c.h % rows for c in cases)                # ragged H
        assert any(c.w % cols for c in cases)                # ragged W
        assert any(c.c_out > 2 * c_out_tile for c in cases)  # 3 C_out tiles
        assert any(c.n == 1 for c in cases)
        assert any(not c.noise and c.clamp is None and not c.demodulate
                   for c in cases)
    # The predicate's C_in % 16 keeps every fp32 chunk whole.
    assert all(c.c_in % FP32_TILE[2] == 0 for c in cs.KERNEL_CASES)
    on_path = [(c.c_in, c.h, c.dtype) for c in cs.KERNEL_CASES if c.on_path]
    assert on_path == [(256, 128, torch.bfloat16), (128, 256, torch.bfloat16),
                       (256, 128, torch.float32), (128, 256, torch.float32)]


@CASES
def test_plain_version_runs_on_cpu(case):
    case = case._replace(n=1)
    a = cs.level_inputs(case, seed=0, device="cpu")
    y = fmc.fused_modconv3x3_ref(a["x"], a["w"], a["styles"], a["dcoefs"],
                                 a["noise"], a["bias"], clamp=case.clamp)
    assert y.dtype == case.dtype
    assert tuple(y.shape) == (1, case.c_out, case.h, case.w)
    assert bool(torch.isfinite(y.float()).all())


# ----------------------------------------------------------------------------
# The train phase's configuration and control flow


def test_train_configs_are_the_clis_1024_plan():
    """entry.train_configs(32) is what the training CLI builds for a
    1024^2 run on one device (cli/train.py, --cfg auto, the defaults): the
    forward's G with the CLI's 2 mapping layers."""
    import dataclasses

    from gagan_tpu_torch import entry
    from gagan_tpu_torch.cli import train as train_cli
    from gagan_tpu_torch.models import stylegan2 as sg2

    g, d, t, a = entry.train_configs(cs.TRAIN_BATCH)
    assert g == dataclasses.replace(
        entry.entry_config(), mapping=sg2.MappingConfig(num_layers=2))
    assert g.synthesis.pallas_level
    run = train_cli.build_run(1024, batch=cs.TRAIN_BATCH)
    assert (g, d, t, a) == (run.g_cfg, run.d_cfg, run.train_cfg,
                            run.augment_cfg)
    assert run.reg_remat and not run.main_remat
    assert (d.architecture, d.channel_base, d.channel_max, d.num_fp16_res,
            d.conv_clamp, d.mbstd_group_size, d.packed_first_block,
            d.packed_head_blocks) == ("resnet", 32768, 512, 4, 256, 4, True, 1)
    # --cfg auto derives gamma and the EMA length from its own batch at
    # 1024^2 (4096 // 1024 = 4) before --batch 32 replaces the batch, as
    # the JAX command does (gagan_tpu/cli/train.py:148-158).
    assert (t.g_lr, t.d_lr, t.ema_kimg, t.ema_rampup, t.ada_target,
            t.batch_size, t.simultaneous_main) == (
        0.002, 0.002, 1.25, 0.05, 0.6, 32, True)
    assert t.loss.r1_gamma == pytest.approx(0.0002 * 1024 ** 2 / 4)
    assert (t.accum_rounds, t.g_reg_accum_rounds, t.d_reg_accum_rounds) == (
        4, 2, 4)
    assert a == augment.make_config("bgc", compute_dtype="bfloat16")
    for batch, cap, want in ((32, 8, 4), (32, 16, 2), (24, 16, 2),
                             (20, 8, 4), (7, 8, 1)):
        assert train_cli.rounds_for(batch, cap) == want
    # Eight fused launches a variant: 2 levels a G forward x 4 rounds.
    live = t.batch_size // t.accum_rounds
    assert cs.expected_launches(g, live) * t.accum_rounds == 8
    assert sum(cs.SCHEDULE.values()) == 16


def test_train_phase_runs_on_cpu(monkeypatch):
    """The train phase's control flow at 32x32 on the CPU: every check,
    the GA round, the gradient comparison and the trace path (no CUDA
    kernels there: 0 launches expected, device time not measured)."""
    import dataclasses

    from gagan_tpu_torch import entry
    from gagan_tpu_torch.train import train_step as ts

    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)

    def configs(batch):
        g, d, t, a = entry.train_configs(batch, 32, 256)
        return g, d, dataclasses.replace(
            t, accum_rounds=2, g_reg_accum_rounds=2, d_reg_accum_rounds=2), a

    def small_entry(device, batch, ada_p):
        g, d, t, a = configs(batch)
        _, state, inputs = entry.train_entry(
            "cpu", batch=batch, img_resolution=32, channel_base=256,
            ada_p=ada_p)
        g_tx, d_tx, _, _ = ts.build_optimizers(t, state.g_params,
                                               state.d_params)
        pl = dataclasses.replace(g, synthesis=dataclasses.replace(
            g.synthesis, pallas_level=False))
        steps = {n: ts.make_fused_step(t, g, d, g_tx, d_tx,
                                       augment.make_augment_fn(a),
                                       do_g_reg=dg, do_d_reg=dd,
                                       reg_g_cfg=pl if dg else None)
                 for n, dg, dd in (("none", False, False),
                                   ("greg", True, False),
                                   ("both", True, True))}
        return steps, state, inputs

    monkeypatch.setattr(cs, "TRAIN_BATCH", 16)
    monkeypatch.setattr(cs, "train_configs", configs)
    monkeypatch.setattr(cs, "train_entry", small_entry)
    launches, seconds, peak_mem, sec_per_batch = cs.train_phase("cpu")
    assert launches == 0 and set(seconds) == set(cs.SCHEDULE)
    assert sec_per_batch > 0


# ----------------------------------------------------------------------------
# The loop, remat and snapshot-cli phases' control flow


def test_loop_remat_cli_phases_run_on_cpu(monkeypatch, tmp_path):
    """The three phases after the train phase, on the CPU at a small size:
    the loop through the training command (16^2, batch 4, --kimg 0: one
    batch with both reg phases, one tick), the remat comparison on the
    train phase's small configs, and generate / style_mixing on the loop's
    snapshot.  No CUDA kernels here: every expected launch count is 0."""
    import dataclasses

    from gagan_tpu_torch import entry

    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "expected_launches", lambda *a: 0)
    for name, value in (("DEVICE", "cpu"), ("LOOP_RES", 16),
                        ("LOOP_BATCH", 4), ("LOOP_IMAGES", 5),
                        ("LOOP_KIMG", 0), ("REMAT_BATCH", 4)):
        monkeypatch.setattr(cs, name, value)

    def configs(batch):
        g, d, t, a = entry.train_configs(batch, 32, 256)
        return g, d, t, a

    monkeypatch.setattr(cs, "train_configs", configs)
    monkeypatch.setattr(cs, "train_entry", lambda device, batch, ada_p:
                        entry.train_entry(device, batch=batch,
                                          img_resolution=32, channel_base=256,
                                          ada_p=ada_p))
    snap, launches, sec_per_kimg, _ = cs.loop_phase(str(tmp_path), "cpu",
                                                    1.0)
    assert launches == 0 and sec_per_kimg > 0
    assert os.path.basename(snap) == "network-snapshot-000000.npz"
    assert cs.remat_phase("cpu") == 0
    assert cs.cli_snapshot_phase(snap) == 0
    assert {"proj00.png", "grid.png"} <= set(
        os.listdir(tmp_path / "run" / "generate")) | set(
        os.listdir(tmp_path / "run" / "style_mixing"))


# ----------------------------------------------------------------------------
# The adapt phase's control flow


def test_adapt_phase_runs_on_cpu(monkeypatch):
    """The adapt phase on the CPU at the tiny size of entry.adapt_entry:
    cli/adapt.py on td_nada_sdelta.yaml (3 steps, tiny random towers), the
    --s-direction images, the gradient check and the timing and trace
    paths.  No CUDA kernels here: every expected launch count is 0."""
    from gagan_tpu_torch import entry

    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "expected_launches", lambda *a: 0)
    monkeypatch.setattr(cs, "adapt_g_config", lambda: entry.TINY_G)
    for name, value in (("DEVICE", "cpu"), ("ADAPT_ITERS", 3),
                        ("ADAPT_BACKUP", 2), ("ADAPT_LOG", 2),
                        ("ADAPT_BATCH", 2), ("ADAPT_BLOCKS", 1),
                        ("ADAPT_CLIP_OVERRIDES", entry.TINY_CLIP)):
        monkeypatch.setattr(cs, name, value)
    launches, rate = cs.adapt_phase("cpu")
    assert launches == 0 and rate > 0


def test_adapt_phase_drives_the_full_size_path():
    """On the card the phase runs FFHQ-1024 with 8 mapping layers and the
    fused level (2 launches a joint pass of 2 x 4 samples), the real
    td_nada_sdelta.yaml, and checkpoints at step 20 of 21."""
    from gagan_tpu_torch import entry
    from gagan_tpu_torch.utils import yaml_subset

    g = cs.adapt_g_config()
    assert g == entry.entry_config() and g.mapping.num_layers == 8
    assert g.synthesis.pallas_level
    assert cs.expected_launches(g, 2 * cs.ADAPT_BATCH) == 2
    cfg = yaml_subset.read(os.path.join(os.path.dirname(cs.__file__),
                                        cs.ADAPT_CONFIG))
    assert cfg["training"]["patch_key"] == "s_delta"
    assert cfg["training"]["batch_size"] == cs.ADAPT_BATCH
    assert cfg["training"]["visual_encoders"] == ["ViT-B/32"]
    assert (cs.ADAPT_ITERS, cs.ADAPT_BACKUP, cs.ADAPT_LOG) == (21, 20, 10)
    assert cs.ADAPT_CLIP_OVERRIDES is None


# ----------------------------------------------------------------------------
# The fewshot phase's control flow


def test_fewshot_phase_runs_on_cpu(monkeypatch, tmp_path):
    """The fewshot phase on the CPU at a small size, after the loop phase
    that it takes its PNGs and snapshot from: the conversion through the
    command's process, cli/train.py with the Affine+ options on block b8
    of a 16^2 run (2 batches of 4), generate --s-direction, the timed
    variants of entry.fewshot_entry at 64^2, the gradient check and the
    layer probe with the tiny CLIP.  No CUDA kernels here: every expected
    launch and backward count is 0."""
    from gagan_tpu_torch import entry

    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "expected_launches", lambda *a: 0)
    for name, value in (("DEVICE", "cpu"), ("LOOP_RES", 16),
                        ("LOOP_BATCH", 4), ("LOOP_IMAGES", 5),
                        ("LOOP_KIMG", 0), ("TRAIN_BATCH", 8),
                        ("FEWSHOT_BLOCK", 8), ("FEWSHOT_KIMG", 0.008),
                        ("PROBE_K", 3),
                        ("ADAPT_CLIP_OVERRIDES", entry.TINY_CLIP)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "fewshot_entry", lambda device, batch, ada_p:
                        entry.fewshot_entry(device, batch=batch,
                                            img_resolution=64,
                                            channel_base=256, ada_p=ada_p))
    monkeypatch.setattr(cs, "fewshot_run", lambda batch: entry.train_run(
        batch, 64, 256, **entry.FEWSHOT_OPTIONS))
    snap, _, _, _ = cs.loop_phase(str(tmp_path), "cpu", 1.0)
    launches, seconds, peak_mem, sec_per_kimg = cs.fewshot_phase(
        str(tmp_path), snap, "cpu")
    assert launches == 0 and set(seconds) == set(cs.SCHEDULE)
    assert sec_per_kimg > 0
    assert {"adaptation-000000.npz", "stats.jsonl"} <= set(
        os.listdir(tmp_path / "fewshot"))


def test_fewshot_phase_drives_the_full_size_path():
    """On the card: bench_adapt10's options (b64 weight offsets, glrate
    0.02) at --batch 32 for 128 images, the probe at batch 2 for 2
    iterations on the 18 w layers of FFHQ-1024."""
    from gagan_tpu_torch import entry

    assert cs.fewshot_parts() == entry.FEWSHOT_OPTIONS[
        "generator_requires_grad_parts"]
    assert cs.fewshot_flags()[2] == "out_in_additive"
    assert (cs.FEWSHOT_BLOCK, cs.FEWSHOT_KIMG, cs.LOOP_BATCH) == (64, 0.128,
                                                                  32)
    run = cs.fewshot_run(cs.TRAIN_BATCH)
    assert run.parametrization == "out_in_additive"
    assert run.train_cfg.g_lr == 0.02 and run.g_cfg.num_ws == 18
    assert (cs.PROBE_BATCH, cs.PROBE_ITERS) == (2, 2)


# ----------------------------------------------------------------------------
# The im2im phase's control flow


def test_im2im_phase_runs_on_cpu(monkeypatch):
    """The im2im phase on the CPU at the tiny size of entry.adapt_entry:
    the projector command (3 steps), the three image-driven configs (2
    steps, projected for 2), the gradient checks and the timing and trace
    paths of the DiFa step (e4e at 64^2 for time).  No CUDA kernels here:
    every expected launch and backward count is 0."""
    from gagan_tpu_torch import entry
    from gagan_tpu_torch.train import adaptation as tad

    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "expected_launches", lambda *a: 0)
    monkeypatch.setattr(cs, "adapt_g_config", lambda: entry.TINY_G)
    monkeypatch.setattr(tad, "E4E_SIZE", 64)
    monkeypatch.delenv("GAGAN_CLIP_DIR", raising=False)
    monkeypatch.delenv("GAGAN_DETECTOR_DIR", raising=False)
    for name, value in (("DEVICE", "cpu"), ("PROJECT_STEPS", 3),
                        ("IM2IM_ITERS", 2), ("IM2IM_LOG", 1),
                        ("IM2IM_INVERSION", 2), ("IM2IM_BATCH", 2),
                        ("IM2IM_BLOCKS", 1),
                        ("ADAPT_CLIP_OVERRIDES", entry.TINY_CLIP)):
        monkeypatch.setattr(cs, name, value)
    launches, flags, rate = cs.im2im_phase("cpu")
    assert launches == 0 and flags == [] and rate > 0


def test_im2im_phase_drives_the_full_size_path():
    """On the card: FFHQ-1024 (18 W+ layers) with the fused level at batch
    1 (the projector and the style latents' render) and at the joint passes
    of the configs (2 x 2) and of the timed DiFa step (2 x 4); 20 projector
    steps, the three configs for 11 steps each, and e4e at 256^2."""
    from gagan_tpu_torch.train import adaptation as tad
    from gagan_tpu_torch.utils import yaml_subset

    g = cs.adapt_g_config()
    assert g.num_ws == 18 and g.synthesis.pallas_level
    for batch in (1, 2, 4, 8):
        assert cs.expected_launches(g, batch) == 2
    assert (cs.PROJECT_STEPS, cs.IM2IM_ITERS, cs.IM2IM_LOG,
            cs.IM2IM_INVERSION, cs.IM2IM_BATCH) == (20, 11, 10, 10, 4)
    assert cs.PROJECT_NEEDS == (True, False, True, True, True, False)
    trainers = {}
    for config in cs.IM2IM_CONFIGS:
        cfg = yaml_subset.read(os.path.join(os.path.dirname(cs.__file__),
                                            "configs", f"{config}.yaml"))
        assert cfg["inversion"]["latents"] is None
        trainers[config] = (cfg["exp"]["trainer"],
                            cfg["training"]["batch_size"])
    assert trainers == {"im2im_difa": ("im2im_difa", 2),
                        "im2im_jojo": ("im2im_JoJo", 2),
                        "im2im_mtg": ("im2im_single", 2)}
    assert tad.E4E_SIZE == 256


# ----------------------------------------------------------------------------
# The ga and metrics phases' control flow


def toy_detector(name, device="cpu"):
    """Stand-ins of the four detectors with their random tags: 8x8 pixels
    projected to 16 features (the towers are held against JAX by their own
    tests; here they would cost minutes of CPU time)."""
    from gagan_tpu_torch.metrics.detectors import Detector
    from gagan_tpu_torch.ops.resize import resize2d

    w = torch.from_numpy(np.random.RandomState(0).randn(192, 16).astype(
        np.float32))

    def feats(images):
        x = resize2d(images.float() / 255.0, (8, 8), "bilinear")
        return x.reshape(x.shape[0], -1) @ w

    tags = {"inception": "inception-random",
            "inception_softmax": "inception-random-softmax",
            "vgg16": "vgg16-random", "vgg16_lpips": "vgg16-lpips-random"}
    fn = ((lambda img: torch.softmax(feats(img), dim=1))
          if name == "inception_softmax" else feats)
    return Detector(tags[name], fn, 16)


def test_ga_and_metrics_phases_run_on_cpu(monkeypatch, tmp_path):
    """The ga and metrics phases on the CPU, after the loop phase that they
    take their PNGs and snapshot from (32^2, 5 PNGs): the GA in both modes
    at the tiny size of entry.ga_entry (32 candidates of 4 images, one
    generation), the pallas-vs-composed, trace and calculate_metrics paths;
    calc_metrics twice with fid1k / kid1k at 4 generated images (cache,
    jsonl lines, warning), PR / IS / PPL at 10 samples (one an IS split),
    the Inception check
    and the rate, with small stand-in detectors.  No CUDA kernels here:
    every expected launch count is 0."""
    from gagan_tpu_torch import entry
    from gagan_tpu_torch.metrics import fid as fid_lib
    from gagan_tpu_torch.metrics import kid as kid_lib

    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "expected_launches", lambda *a: 0)
    monkeypatch.setattr(cs, "adapt_g_config", lambda: entry.TINY_G)
    monkeypatch.setattr(cs.detectors, "make_default", toy_detector)
    monkeypatch.delenv("GAGAN_DETECTOR_DIR", raising=False)
    for name, value in (("DEVICE", "cpu"), ("LOOP_RES", 32),
                        ("LOOP_BATCH", 4), ("LOOP_IMAGES", 5),
                        ("LOOP_KIMG", 0), ("GA_GENERATIONS", 1),
                        ("GA_EVAL_IMAGES", 4), ("METRICS_BATCH", 2),
                        ("METRICS_SAMPLES", 10)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "train_configs", lambda batch: entry.train_configs(
        batch, 32, 256))
    real_fid, real_kid = fid_lib.compute_fid, kid_lib.compute_kid
    monkeypatch.setattr(fid_lib, "compute_fid", lambda opts, max_real, num_gen:
                        real_fid(opts, max_real, 4))
    monkeypatch.setattr(kid_lib, "compute_kid", lambda opts, max_real, num_gen:
                        real_kid(opts, max_real, 4, max_subset_size=4))

    snap, _, _, _ = cs.loop_phase(str(tmp_path), "cpu", 1.0)
    launches, run = cs.ga_phase(str(tmp_path), "cpu")
    assert launches == {"scan": 0, "batched": 0}
    assert run["scores"].shape == (run["population"].shape[0],)
    assert cs.metrics_phase(str(tmp_path), snap, "cpu") == (0, 0)
    assert {"metric-fid1k.jsonl", "metric-kid1k.jsonl"} <= set(
        os.listdir(os.path.dirname(snap)))


def test_ga_and_metrics_phases_drive_the_full_size_path():
    """On the card: the GA on FFHQ-1024 (2 fused levels at batch 4 and at
    batch 128) with Swin-T and bench_ga_search.py's population, 2
    generations: 192 launches scan, 6 batched; calc_metrics at batch 32
    (32 G calls a metric); PR / IS / PPL at 256 samples."""
    from gagan_tpu_torch import entry
    from gagan_tpu_torch.models import swin

    g = cs.adapt_g_config()
    assert g.img_resolution == 1024 and g.synthesis.pallas_level
    assert cs.expected_launches(g, 4) == cs.expected_launches(g, 128) == 2
    cfg = entry.ga_entry.__defaults__
    assert cfg[:2] == ("cuda", "scan")
    assert (cs.GA_GENERATIONS, cs.GA_EVAL_IMAGES) == (2, 32)
    assert 2 * 32 * (cs.GA_GENERATIONS + 1) == 192
    assert 2 * (cs.GA_GENERATIONS + 1) == 6
    assert swin.swin_tiny_config() == swin.SwinConfig()
    assert cs.METRICS == ("fid1k", "kid1k")
    assert (cs.METRICS_BATCH, cs.METRICS_SAMPLES) == (32, 256)
    fp32 = [(c.c_in, c.h) for c in cs.KERNEL_CASES
            if c.on_path and c.dtype == torch.float32]
    assert fp32 == [(256, 128), (128, 256)]


# ----------------------------------------------------------------------------
# The inversion phase's control flow


def test_inversion_phase_runs_on_cpu(monkeypatch, tmp_path):
    """The inversion phase on the CPU with entry.TINY_RESTYLE_G (256^2,
    the encoders' 14 heads): every encoder type for 1 iteration, the
    converter, the three Inferencer adaptations, II2S for 2 steps (PCA of
    600 samples) with a stand-in detector, the editors (StyleFlow at its
    real config) and the latent D.  No CUDA kernels here: every expected
    launch and backward count is 0."""
    from gagan_tpu_torch import entry
    from gagan_tpu_torch.metrics import detectors

    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "expected_launches", lambda *a: 0)
    monkeypatch.setattr(cs, "inversion_g_config", lambda: entry.TINY_RESTYLE_G)
    monkeypatch.setattr(detectors, "make_default", toy_detector)
    for name, value in (("DEVICE", "cpu"), ("RESTYLE_ITERS", 1),
                        ("RESTYLE_BATCH", 1), ("RESTYLE_TIMED", 1),
                        ("II2S_STEPS", 2), ("II2S_PCA", 600),
                        ("D_STEPS", 1)):
        monkeypatch.setattr(cs, name, value)
    launches, needs = cs.inversion_phase(str(tmp_path), "cpu")
    assert launches == 0 and needs == []


def test_inversion_phase_drives_the_full_size_path():
    """On the card: FFHQ-1024 (18 W+ layers, the fused level at b128.conv1
    and b256.conv1, the edits' layers), 5 ReStyle iterations, batch 4, 20
    II2S steps on a PCA of 100,000 samples, a pool of 50."""
    g = cs.inversion_g_config()
    assert g.num_ws == 18 and g.synthesis.pallas_level
    names = g.synthesis.layer_names()
    assert [names[layer] for (layer, _), _, _ in cs.STYLE_EDITS] == [
        "b128.conv1", "b256.conv1"]
    assert cs.expected_launches(g, 1) == 2
    assert (cs.RESTYLE_ITERS, cs.RESTYLE_BATCH, cs.II2S_STEPS, cs.II2S_PCA,
            cs.POOL_SIZE, cs.D_STEPS) == (5, 4, 20, 100_000, 50, 3)
    assert cs.II2S_NEEDS == (True, False, True, True, False, False)
    assert cs.RESTYLE_HELD_ITERS == 5


def test_sass_hot_loop_counts_the_innermost_loop_with_most_ffma():
    """The build phase's SASS summary of the fp32 kernel, on a cut-down
    ``cuobjdump -sass`` listing: a loop is the span from a backward
    branch's target to the branch; the outer loop (more FFMA, one loop
    inside) is passed over for the inner one; opcodes drop their
    modifiers; the next function is not counted."""
    sass = """
        Function : _Z19modconv_fp32_kernelPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FFMA R8, R4, R5, R8 ;
        /*0030*/                   FFMA R9, R4, R6, R9 ;
        /*0040*/              @!P0 BRA 0x10 ;
        /*0050*/                   LDS R4, [R2] ;
        /*0060*/                   FFMA R8, R4, R5, R8 ;
        /*0070*/              @!P1 BRA 0x10 ;
        /*0080*/                   FFMA R8, R4, R5, R8 ;
        /*0090*/                   BRA 0x80 ;
        /*00a0*/                   EXIT ;
        Function : _Z19modconv_bf16_kernelPK13__nv_bfloat16
        /*0000*/                   FFMA R8, R4, R5, R8 ;
        /*0010*/                   FFMA R8, R4, R5, R8 ;
        /*0020*/                   FFMA R8, R4, R5, R8 ;
        /*0030*/                   BRA 0x0 ;
"""
    n, loop = cs.sass_hot_loop(sass, "modconv_fp32_kernel")
    assert n == 11
    assert loop == {"LDS": 1, "FFMA": 2, "BRA": 1}


# ----------------------------------------------------------------------------
# The warp and face phases' control flow


def test_warp_phase_runs_on_cpu(monkeypatch):
    """The warp phase on the CPU at 64^2, batch 2: both geometry modes
    timed, then the card-vs-CPU check with the CPU on both sides."""
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    for fn in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: 0)
    for name, value in (("DEVICE", "cpu"), ("TRAIN_BATCH", 2),
                        ("WARP_RES", 64), ("WARP_ITERS", 1)):
        monkeypatch.setattr(cs, name, value)
    out = cs.warp_phase("cpu")
    assert set(out) == {"fast", "exact"}
    assert all(v[0] > 0 and v[1] > 0 for v in out.values())


def test_face_phase_runs_on_cpu(monkeypatch):
    """The face phase on the CPU: the 1024^2 photo's cascade (the CPU on
    both sides), the alignment at 1024 from a 2048 transform, MTCNN.align
    and e4e in front of a narrow 1024^2 generator.  No CUDA kernels here:
    0 launches expected."""
    from gagan_tpu_torch.models import stylegan2 as sg2

    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(cs, "expected_launches", lambda *a: 0)
    monkeypatch.setattr(cs, "face_g_config", lambda: sg2.GeneratorConfig(
        img_resolution=1024, mapping=sg2.MappingConfig(num_layers=2),
        synthesis=sg2.SynthesisConfig(channel_base=8192, channel_max=8,
                                      pallas_level=True)))
    for name, value in (("DEVICE", "cpu"), ("FACE_TRANSFORM", 2048)):
        monkeypatch.setattr(cs, name, value)
    assert cs.face_phase("cpu") == 0


def test_face_and_warp_phases_drive_the_full_size_path():
    """On the card: a 1024^2 photo aligned through a 4096^2 quad map, e4e
    in front of the FFHQ-1024 generator with the fused level (2 launches);
    the ADA pipe at the train phase's batch and 1024^2."""
    g = cs.face_g_config()
    assert g.img_resolution == 1024 and g.synthesis.pallas_level
    assert cs.expected_launches(g, 1) == 2
    assert (cs.FACE_RES, cs.FACE_TRANSFORM) == (1024, 4096)
    assert cs.FACE_THRESHOLDS == (0.15, 0.25, 0.35)
    assert (cs.WARP_RES, cs.TRAIN_BATCH) == (1024, 32)


# ----------------------------------------------------------------------------
# The state, tail, examples and zoo phases' control flow


def _cpu_card(monkeypatch):
    """torch.cuda's timing and memory calls as no-ops, and the phases' CUDA
    event timer as a wall clock, for runs on the CPU."""
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters=1, warmup=0:
                        cs.wall_ms(fn, 1))
    monkeypatch.setattr(cs, "DEVICE", "cpu")


def _small_g(pallas_level=True):
    from gagan_tpu_torch.models import stylegan2 as sg2

    return sg2.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=64,
        mapping=sg2.MappingConfig(num_layers=2),
        synthesis=sg2.SynthesisConfig(
            channel_base=1024, channel_max=32, num_fp16_res=2,
            conv_clamp=256, packed_last_block=True,
            pallas_level=pallas_level))


def test_state_phase_runs_on_cpu(monkeypatch):
    """The round trip of a small train state and the three steps; on the
    CPU the steps are bit-equal, so the bound is 0 and it holds."""
    from gagan_tpu_torch import entry

    _cpu_card(monkeypatch)
    steps, state, inputs = entry.train_entry("cpu", batch=4, img_resolution=32,
                                             channel_base=256, ada_p=0.2)
    launches = cs.state_phase(dict(steps=steps, state=state, inputs=inputs),
                              "cpu")
    assert launches == 0


def test_tail_phase_runs_on_cpu(monkeypatch):
    """The tail phase at 64^2 (packed_tail_blocks 1-3 cover blocks 64, 32
    and 16), the "orig" G, and the train step with two packed blocks at
    32^2."""
    import dataclasses

    from gagan_tpu_torch import entry

    _cpu_card(monkeypatch)
    monkeypatch.setattr(cs, "expected_launches", lambda *a: 0)
    monkeypatch.setattr(cs, "entry_config", _small_g)
    for name, value in (("BATCH", 2), ("TIMED_BATCH", 2), ("TRAIN_BATCH", 4)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "train_entry", lambda device, batch, ada_p, **kw:
                        entry.train_entry(device, batch=batch,
                                          img_resolution=32, channel_base=256,
                                          ada_p=ada_p, **kw))
    monkeypatch.setattr(cs, "train_run", lambda batch, **kw: entry.train_run(
        batch, 32, 256, **kw))
    assert cs.tail_phase("cpu", 1.0) == 0
    cfg = cs.tail_config(3, fused=False)
    assert (cfg.synthesis.packed_tail_blocks, cfg.synthesis.packed_fused_torgb,
            cfg.synthesis.architecture) == (3, False, "skip")
    assert cs.tail_config(1, architecture="orig").synthesis.architecture == \
        "orig"
    assert dataclasses.replace(cfg.synthesis, packed_tail_blocks=1,
                               packed_fused_torgb=True) == \
        _small_g().synthesis


def test_examples_phase_runs_on_cpu(monkeypatch, tmp_path):
    """The five examples at 32^2 on the CPU, fused and composed snapshots
    (no CUDA kernel: 0 launches), each PNG at the shape it has at 1024^2
    (the examples resize to fixed sizes)."""
    _cpu_card(monkeypatch)
    monkeypatch.setattr(cs, "expected_launches", lambda *a: 0)
    monkeypatch.setattr(cs, "EXAMPLES_RES", 32)
    assert cs.examples_phase(str(tmp_path), "cpu") == 0
    assert set(cs.EXAMPLE_FORWARDS) == set(cs.EXAMPLE_PNGS) == set(
        cs.examples_entry("cpu", 32, str(tmp_path / "x")))


def test_zoo_phase_runs_on_cpu(monkeypatch, tmp_path):
    """The zoo phase on the CPU at batch 2 with a 64^2 StyleGAN2, a 32^2
    BigGAN of ch 8 and both SN-GANs (ProgGAN's fixed 1024^2 stays on the
    card and in tests/test_torch_zoo.py)."""
    from gagan_tpu_torch import entry

    _cpu_card(monkeypatch)
    monkeypatch.setattr(cs, "expected_launches", lambda *a: 0)
    monkeypatch.setattr(cs, "entry_config", _small_g)
    monkeypatch.setattr(cs, "ZOO_BATCH", 2)
    monkeypatch.setattr(cs, "ZOO_MODELS",
                        ("stylegan2", "sn_anime", "sn_mnist", "biggan"))

    def small_zoo(device, name, batch, **kw):
        if name == "biggan":
            kw = dict(kw, ch=8, resolution=32, attention=16)
            kw.pop("snapshot_path")
        return entry.zoo_entry(device, name, batch, **kw)

    monkeypatch.setattr(cs, "zoo_entry", small_zoo)
    assert cs.zoo_phase(str(tmp_path), "cpu") == 0


def test_new_phases_drive_the_full_size_path():
    """On the card: the examples and the zoo's stylegan2 at FFHQ-1024 with
    the fused level (2 launches a G forward), the zoo's five models at
    batch 8 with BigGAN-PyTorch's 128^2 widths, the packed tail over 1-3
    blocks (3 blocks leave b128.conv1 alone fused), the train state of the
    train phase."""
    from gagan_tpu_torch import entry

    assert cs.EXAMPLES_RES == 1024 and cs.ZOO_BATCH == 8
    assert cs.examples_config(cs.EXAMPLES_RES) == entry.entry_config()
    assert cs.ZOO_MODELS == ("stylegan2", "proggan", "sn_anime", "sn_mnist",
                             "biggan")
    assert entry.BIGGAN_128 == dict(ch=96, dim_z=120, shared_dim=128,
                                    resolution=128, hier=True, attention=64)
    assert [cs.expected_launches(cs.tail_config(n), 8)
            for n in cs.TAIL_BLOCKS] == [2, 2, 1]
    assert cs.expected_launches(cs.tail_config(1, architecture="orig"), 8) == 2
    assert cs.TAIL_TRAIN == 2
    assert sum(cs.EXAMPLE_FORWARDS.values()) == 17


def test_dist_phase_drives_the_full_size_path():
    """On the card, the dist phase's ranks run the training command's plan
    for two devices at FFHQ-1024, batch 32: 16 images a rank in main rounds
    of 8 (the train phase's live batch, so two ranks' peaks fit one card),
    Greg in one round of 16, R1 in rounds of 8, the mbstd group of 4; the
    fp32 check against one process runs the same plan, cut to batch 8."""
    from gagan_tpu_torch import entry
    from gagan_tpu_torch.train import train_step as ts

    one = entry.train_run(cs.TRAIN_BATCH)
    two = entry.train_run(cs.TRAIN_BATCH, n_devices=2)
    assert one.accum_rounds == (4, 2, 4)
    assert two.accum_rounds == (2, 1, 2)
    assert two.d_cfg.mbstd_group_size == one.d_cfg.mbstd_group_size == 4
    assert ts.data_rounds(two.train_cfg) == 2
    assert cs.TRAIN_BATCH // 2 // two.train_cfg.accum_rounds == 8
    assert two.reg_remat and two.g_cfg.synthesis.pallas_level
    assert (cs.DIST_LOOP_BATCHES, cs.DIST_RESUME_BATCH) == (4, 8)
    assert cs.DIST_VARIANTS == ("none", "greg", "both")
    assert two.train_cfg.batch_size == cs.TRAIN_BATCH
    # The check against one process: fp32 G, D and ADA pipe at global batch
    # 8, two rounds of 2 a rank, so that mbstd groups of 4 span both ranks.
    check = entry.train_run(cs.DIST_CHECK_BATCH, n_devices=2, fp32=True,
                            batch_gpu=cs.DIST_CHECK_BATCH_GPU)
    assert check.accum_rounds[0] == 2 and ts.data_rounds(check.train_cfg) == 2
    assert check.d_cfg.mbstd_group_size == 4
    assert check.g_cfg.synthesis.bf16_resolution > 1024
    assert check.d_cfg.bf16_resolution > 1024
    assert check.augment_cfg.compute_dtype is None
    assert two.augment_cfg.compute_dtype == "bfloat16"
    assert check.g_cfg.synthesis.pallas_level
    assert {v for _, v in cs.DIST_FAULTS.values()} == {"none", "greg"}
    assert all(cs.DIST_BOUNDS[k] <= 2 ** -7 for k in (
        "D", "loss main", "loss reg", "pl_mean", "w_avg", "G main"))


def test_spatial_phase_runs_on_cpu(tmp_path):
    """The spatial phase's control flow on two CPU ranks over gloo at 16^2
    (channel_base 256; the ranks take the sizes as SpatialPlan, since they
    re-import the script): the forward within its bound and zero-filled
    halos past it, the fp32 step within SPATIAL_BOUNDS and both planted
    faults past them, the four arms, the loop writing from rank 0.  On the
    CPU there is no fused launch and no peak memory to compare."""
    from gagan_tpu_torch.utils.png import write_png

    data = tmp_path / "imgs"
    data.mkdir()
    rng = np.random.RandomState(0)
    for i in range(8):
        write_png(str(data / f"{i:03d}.png"),
                  rng.randint(0, 256, (16, 16, 3)).astype(np.uint8))
    plan = cs.SpatialPlan(res=16, channel_base=256, fwd_batch=2,
                          fwd_min_res=(8, 4), check_batch=4, arm_batch=4,
                          arm_min_res=(8, 4), loop_batch=4, loop_batches=2,
                          device="cpu")
    assert cs.spatial_phase(str(tmp_path), str(data), "cpu", plan) == 0


def test_spatial_phase_drives_the_full_size_path():
    """On the card: FFHQ-1024 at full width with the CLI's G (bf16 in 4
    resolutions, conv_clamp 256, the packed last block, the fused level),
    min_res 256 (b128.conv1 stays fused on every rank) and 64 / 128; the
    fp32 check at global batch 4 in one round a rank with the GA round;
    the arms at global batch 8; the bounds at most 2^-4."""
    from gagan_tpu_torch import entry

    plan = cs.SPATIAL
    assert (plan.res, plan.channel_base, plan.device) == (1024, None,
                                                          "cuda:0")
    assert plan.fwd_min_res == (256, 64) and plan.arm_min_res == (256, 128)
    g = entry.train_run(plan.fwd_batch).g_cfg
    assert g.synthesis.num_fp16_res == 4 and g.synthesis.conv_clamp == 256
    assert g.synthesis.packed_last_block and g.synthesis.pallas_level
    assert g.synthesis.channel_base == 32768
    check = entry.train_run(plan.check_batch, n_devices=2, fp32=True,
                            ga_threshold=0.5)
    assert check.accum_rounds[0] == 1 and check.train_cfg.ga_threshold
    assert entry.train_run(plan.arm_batch, n_devices=2).accum_rounds[0] == 1
    assert plan.check_batch <= 8 and plan.arm_batch == 8
    assert set(cs.SPATIAL_FAULTS) == {"halo rows zero-filled",
                                      "gradients divided by the world size"}
    assert all(v <= 2 ** -4 for v in cs.SPATIAL_BOUNDS.values())
