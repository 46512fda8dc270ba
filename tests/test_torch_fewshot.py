"""Few-shot offsets training (the Affine+ protocol of ``cli/train.py
--use-domain-modulation``) in the port against the JAX package: the offsets
mask of the parts grammar, the offsets' optimizer, the command's
``--dry-run`` plan and configs, a short run of the command whose adaptation
checkpoint JAX reads and renders as the port does (images: 2e-4 of
max|image|), and two faults of the JAX loop that the port reproduces.  The
fused step with offsets is held against JAX's in
tests/test_torch_fewshot_step.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.cli import train as jtrain
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.params import offsets as joffs
from gagan_tpu.train import loop as jloop
from gagan_tpu.train import masks as jmasks
from gagan_tpu.train import train_step as jts
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch import entry
from gagan_tpu_torch.cli import train as ttrain
from gagan_tpu_torch.data import ImageFolderDataset
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.params import offsets as toffs
from gagan_tpu_torch.train import loop as tloop
from gagan_tpu_torch.train import masks as tmasks
from gagan_tpu_torch.train import train_step as tts
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils import config as tconfig
from gagan_tpu_torch.utils.rng import Rng

from .test_torch_augment import JaxRng
from .test_torch_cli_train import _folder
from .test_torch_gan_loss import tiny_cfgs, tiny_weights

torch.set_num_threads(2)

# The bench_adapt10 parts at the tiny configs' 32^2: G's affines and the
# weight offsets of an inner block (b64 at 1024^2, b16 here).
PARTS = ("synt_affine", "tRGB_affine", "synt_weights_offset.b16",
         "tRGB_weights_offset.b16")


# ----------------------------------------------------------------------------
# The offsets mask


@pytest.mark.parametrize("parts", [
    ("all",), PARTS, ("synt_weights_offset",), ("tRGB_weights_offset.b8",),
    ("synt_offset", "tRGB_offset.b32"), ("synt_affine_weights_offset",),
    ("tRGB_affine_weights_offset.b16", "mapping")])
def test_offsets_mask_matches_jax(parts):
    g, _ = tiny_cfgs(jsg)
    spec = "additive,out_in_2_2_train_out,affine_out_in_2_1_additive"
    joff = joffs.init_offsets(jax.random.PRNGKey(0), g.synthesis,
                              joffs.OffsetsSpec.from_string(spec))
    want = jck.tree_to_flat(jmasks.offsets_mask(joff, parts))
    toff = toffs.init_offsets(JaxRng(jax.random.PRNGKey(0)),
                              tiny_cfgs(tsg)[0].synthesis,
                              toffs.OffsetsSpec.from_string(spec))
    got = tck.tree_to_flat_tensors(tmasks.offsets_mask(toff, parts))
    assert {k: bool(v) for k, v in want.items()} == got
    if parts == PARTS:
        # The b16 weight offsets and every affine offset (synt_affine and
        # tRGB_affine name them too); no other weight offset, no style one.
        assert {k for k, v in got.items() if v and ".affine." not in k} == {
            f"b16.{layer}.weights_offset_{side}_{i}"
            for layer in ("conv0", "conv1", "torgb")
            for side in ("in", "out") for i in (0, 1)}
        assert all(v for k, v in got.items() if ".affine." in k)
    with pytest.raises(ValueError, match="Unknown"):
        tmasks.offsets_mask(toff, ("bogus",))


# ----------------------------------------------------------------------------
# The offsets optimizer


def test_offsets_optimizer_is_not_lazily_scaled():
    """G's Adam carries the lazy-regularization scaling; the offsets' does
    not, as the JAX loop builds them."""
    g, _ = tiny_cfgs(tsg)
    cfg = tts.TrainConfig(g_lr=0.02, adam_beta1=0.1, g_reg_interval=4)
    spec = toffs.OffsetsSpec.from_string("out_in_additive", weight_parts=PARTS)
    off = toffs.init_offsets(Rng(0), g.synthesis, spec)
    otx = tts.build_offsets_optimizer(cfg, spec, off, PARTS)
    assert (otx.lr, otx.b1, otx.b2, otx.eps) == (0.02, 0.1, 0.99, 1e-8)
    gflat, dflat = tiny_weights()
    g_tx, _, _, _ = tts.build_optimizers(cfg, tck.flat_to_tree(gflat),
                                         tck.flat_to_tree(dflat))
    assert g_tx.lr == pytest.approx(0.02 * 0.8)
    assert g_tx.b1 == pytest.approx(0.1 ** 0.8)
    assert sorted(k for k, v in otx.mask if v) == [
        "b16.conv0.weights_offset", "b16.conv1.weights_offset",
        "b16.torgb.weights_offset"]


# ----------------------------------------------------------------------------
# The command


FEWSHOT_FLAGS = ["--use-domain-modulation",
                 "--domain-modulation-parametrization", "out_in_additive",
                 "--generator-requires-grad-parts",
                 "synt_affine,tRGB_affine,synt_weights_offset.b64,"
                 "tRGB_weights_offset.b64", "--glrate", "0.02"]


@pytest.mark.parametrize("res", [32, 1024])
@pytest.mark.parametrize("batch", [None, "32"])
def test_domain_modulation_dry_run_matches_jax(res, batch, tmp_path, capsys):
    data = _folder(tmp_path / f"data{res}", res, n=2)
    args = (["--outdir", str(tmp_path / "o"), "--data", data, "--gpus", "1",
             "--dry-run"] + FEWSHOT_FLAGS
            + (["--batch", batch] if batch else []))
    jtrain.main.main(args, standalone_mode=False)
    want = capsys.readouterr().out
    assert ttrain.main(args + ["--device", "cpu"]) is None
    got = capsys.readouterr().out
    assert got == want
    assert "-dm-out_in_additive" in got and "Dry run" in got


def test_domain_modulation_run_configs_match_jax(monkeypatch):
    """The parametrization and weight parts the command hands its loop,
    and the loop's configs, equal the JAX command's."""
    seen = {}

    def fake_loop(loop_cfg, train_cfg, g_cfg, d_cfg, dataset, **k):
        seen.update(train=train_cfg, **k)

    class FakeDataset:
        name, resolution, num_channels, label_dim = "fake", 1024, 3, 0

        def __init__(self, *a, **k):
            pass

    import gagan_tpu.data as jdata
    monkeypatch.setattr(jdata, "ImageFolderDataset", FakeDataset)
    monkeypatch.setattr(jloop, "training_loop", fake_loop)
    jtrain.main.main(["--outdir", "o", "--data", "d", "--gpus", "1",
                      "--batch", "32"] + FEWSHOT_FLAGS, standalone_mode=False)
    run = ttrain.build_run(1024, 3, 0, outdir="o", n_devices=1, batch=32,
                           **entry.FEWSHOT_OPTIONS)
    assert run.parametrization == seen["parametrization"] == "out_in_additive"
    assert run.parts == seen["weight_parts"]
    assert dataclasses.asdict(run.train_cfg) == dataclasses.asdict(
        seen["train"])
    assert run.train_cfg.g_lr == 0.02 and run.train_cfg.d_lr == 0.002
    off = ttrain.build_run(1024, 3, 0, batch=32, use_domain_modulation=False,
                           domain_modulation_parametrization="out_in_additive")
    assert off.parametrization is None


@pytest.fixture(scope="module")
def jax_snapshot_16(tmp_path_factory):
    """A JAX-initialised snapshot of the networks the command builds for
    16^2 images at --batch 4 (G_ema = G), with non-zero noise strengths."""
    run = ttrain.build_run(16, batch=4)
    jg = jconfig.generator_config_from_dict(tconfig.to_dict(run.g_cfg))
    jd = jconfig.discriminator_config_from_dict(tconfig.to_dict(run.d_cfg))
    g = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(1), jg))
    g = {k: (np.float32(0.2) if k.endswith("noise_strength") else v)
         for k, v in g.items()}
    d = jck.tree_to_flat(jsg.init_discriminator(jax.random.PRNGKey(2), jd))
    path = str(tmp_path_factory.mktemp("snap") / "net.npz")
    jck.save_snapshot(path, g_params=jck.flat_to_tree(g),
                      d_params=jck.flat_to_tree(d),
                      g_ema=jck.flat_to_tree(g),
                      config={"g_cfg": jconfig.to_dict(jg),
                              "d_cfg": jconfig.to_dict(jd)})
    return path, g


def test_domain_modulation_command_writes_what_jax_reads(tmp_path,
                                                         monkeypatch,
                                                         jax_snapshot_16):
    """Two batches at 16^2 through the command with an Affine+ spec on the
    b8 weights: adaptation-000000.npz holds the b8 weight offsets' EMA
    (moved from zero), JAX's load_adaptation reads it, and JAX's
    generator_apply with those offsets' hooks renders the port's image of
    the snapshot's G_ema; the resumed conv weights did not move."""
    path, g0 = jax_snapshot_16
    orig = tloop.training_loop

    def short(loop_cfg, *a, **k):
        loop_cfg.total_kimg = 0.008
        loop_cfg.kimg_per_tick = 0.008
        return orig(loop_cfg, *a, **k)

    monkeypatch.setattr(tloop, "training_loop", short)
    data = _folder(tmp_path / "d", 16, n=5)
    out = str(tmp_path / "run")
    state = ttrain.main([
        "--outdir", out, "--data", data, "--gpus", "1", "--cfg", "auto",
        "--batch", "4", "--kimg", "1", "--snap", "1", "--resume", path,
        "--use-domain-modulation", "--domain-modulation-parametrization",
        "out_in_additive", "--generator-requires-grad-parts",
        "synt_affine,tRGB_affine,synt_weights_offset.b8,"
        "tRGB_weights_offset.b8", "--glrate", "0.02", "--device", "cpu"])
    assert state.cur_nimg == 8
    files = set(os.listdir(out))
    assert {"network-snapshot-000000.npz", "adaptation-000000.npz",
            "stats.jsonl", "fakes000000.png"} <= files
    meta, joff, _ = jck.load_adaptation(os.path.join(out,
                                                     "adaptation-000000.npz"))
    assert meta["model_type"] == "parametrization"
    assert meta["parametrization"] == "out_in_additive"
    assert sorted(joff) == ["b8.conv0", "b8.conv1", "b8.torgb"]
    assert all(float(np.abs(v["weights_offset"]).max()) > 0
               for v in joff.values())
    got = tck.tree_to_flat(state.offsets_ema)
    for name, layer in joff.items():
        np.testing.assert_array_equal(got[f"{name}.weights_offset"],
                                      np.asarray(layer["weights_offset"]))
    # G's conv weights are the resumed ones; its affines moved.
    g1 = tck.tree_to_flat(state.g_params)
    assert np.array_equal(g1["synthesis.b8.conv1.weight"],
                          g0["synthesis.b8.conv1.weight"])
    assert not np.array_equal(g1["synthesis.b8.conv1.affine.weight"],
                              g0["synthesis.b8.conv1.affine.weight"])

    trees, cfg = jck.load_snapshot(os.path.join(
        out, "network-snapshot-000000.npz"))
    jg = jconfig.generator_config_from_dict(cfg["g_cfg"])
    spec = joffs.OffsetsSpec.from_string(meta["parametrization"])
    z = np.random.RandomState(0).randn(2, jg.z_dim).astype(np.float32)
    # fp32 (the command's G is bf16 from 8^2 up, where the two packages
    # round differently).
    want = np.asarray(jsg.generator_apply(
        jg, trees["G_ema"], jnp.asarray(z), noise_mode="const",
        hooks=joffs.make_hooks(spec, joff), force_fp32=True))
    tg = tconfig.generator_config_from_dict(cfg["g_cfg"])
    tspec = toffs.OffsetsSpec.from_string(meta["parametrization"])
    tmeta, toff, _ = tck.load_adaptation(os.path.join(
        out, "adaptation-000000.npz"))
    with torch.no_grad():
        img = tsg.generator_apply(
            tg, tck.flat_to_tree(jck.tree_to_flat(trees["G_ema"])),
            torch.from_numpy(z), noise_mode="const",
            hooks=toffs.make_hooks(tspec, toff), force_fp32=True)
    m = float(np.abs(want).max())
    np.testing.assert_allclose(img.numpy(), want, rtol=0, atol=2e-4 * m)
    plain = np.asarray(jsg.generator_apply(jg, trees["G_ema"],
                                           jnp.asarray(z), noise_mode="const",
                                           force_fp32=True))
    assert np.abs(plain - want).max() > 1e-4 * m     # the offsets count


# ----------------------------------------------------------------------------
# Faults of the JAX loop, reproduced by the port


class _Stop(Exception):
    pass


def _idle_step(cfg):
    """A step that only counts images: the loops' bookkeeping without the
    networks' cost."""
    def step(state, real, real_c, z, gen_c, key):
        if isinstance(state, tts.TrainState):
            state.cur_nimg += cfg.batch_size
            return state, {}
        return state.replace(cur_nimg=state.cur_nimg + cfg.batch_size), {}
    return step


def _loops(monkeypatch):
    monkeypatch.setattr(jts, "make_fused_step",
                        lambda cfg, *a, **k: _idle_step(cfg))
    monkeypatch.setattr(tts, "make_fused_step",
                        lambda cfg, *a, **k: _idle_step(cfg))


def _fault_cfgs(gl, lm, run_dir, **kw):
    train = gl.TrainConfig(batch_size=4, g_reg_interval=None,
                           d_reg_interval=None)
    loop = lm.LoopConfig(run_dir=run_dir, total_kimg=0.004,
                         kimg_per_tick=0.004, image_snapshot_ticks=1,
                         network_snapshot_ticks=1, grid_size=(1, 1),
                         log_param_histograms=False, **kw)
    return train, loop


def test_reference_fault_g_ema_only_snapshot_resumes_a_random_g(
        tmp_path, monkeypatch, jax_snapshot_16):
    """A snapshot with G_ema only (tools/convert_weights.py's rosinality
    output) resumes G_ema but leaves the trained G at its random init: the
    JAX loop merges "G" into G and "G_ema" into the EMA alone
    (gagan_tpu/train/loop.py:103-106,141-144).  The port's loop does the
    same."""
    path, g0 = jax_snapshot_16
    ema_only = str(tmp_path / "ema_only.npz")
    trees, cfg = jck.load_snapshot(path)
    jck.save_snapshot(ema_only, g_ema=trees["G_ema"], config=cfg)
    _loops(monkeypatch)
    data = _folder(tmp_path / "d", 16, n=4)
    jg = jconfig.generator_config_from_dict(cfg["g_cfg"])
    jd = jconfig.discriminator_config_from_dict(cfg["d_cfg"])
    train, loop = _fault_cfgs(jts, jloop, str(tmp_path / "j"),
                              resume_from=ema_only, n_devices=1)
    jstate = jloop.training_loop(loop, train, jg, jd,
                                 jloop.ImageFolderDataset(data))
    train, loop = _fault_cfgs(tts, tloop, str(tmp_path / "t"),
                              resume_from=ema_only)
    state = tloop.training_loop(
        loop, train, tconfig.generator_config_from_dict(cfg["g_cfg"]),
        tconfig.discriminator_config_from_dict(cfg["d_cfg"]),
        ImageFolderDataset(data), device="cpu")
    key = "synthesis.b8.conv1.weight"
    for got_g, got_ema in ((jck.tree_to_flat(jstate.g_params),
                            jck.tree_to_flat(jstate.g_ema)),
                           (tck.tree_to_flat(state.g_params),
                            tck.tree_to_flat(state.g_ema))):
        np.testing.assert_array_equal(got_ema[key], g0[key])
        assert not np.allclose(got_g[key], g0[key])     # a random G trains


def test_reference_fault_snapshot_grid_leaves_out_the_offsets(
        tmp_path, monkeypatch, jax_snapshot_16):
    """In an offsets run the loop draws its fakes grid from G_ema without
    the offsets' hooks (gagan_tpu/train/loop.py:218-221,305); only the
    adaptation file carries them.  Shown by the grid's one generator_apply
    call, which gets no hooks while the run has offsets.  The port's loop
    does the same."""
    path, _ = jax_snapshot_16
    _loops(monkeypatch)
    calls = {"jax": [], "torch": []}
    j_apply, t_apply = jsg.generator_apply, tsg.generator_apply

    def j_spy(*a, **k):
        calls["jax"].append(k.get("hooks"))
        return j_apply(*a, **k)

    def t_spy(*a, **k):
        calls["torch"].append(k.get("hooks"))
        return t_apply(*a, **k)

    monkeypatch.setattr(jsg, "generator_apply", j_spy)
    monkeypatch.setattr(tsg, "generator_apply", t_spy)
    data = _folder(tmp_path / "d", 16, n=4)
    _, cfg = jck.load_snapshot(path)
    jg = jconfig.generator_config_from_dict(cfg["g_cfg"])
    jd = jconfig.discriminator_config_from_dict(cfg["d_cfg"])
    parts = ("synt_weights_offset.b8",)
    train, loop = _fault_cfgs(jts, jloop, str(tmp_path / "j"),
                              resume_from=path, n_devices=1)
    jloop.training_loop(loop, train, jg, jd, jloop.ImageFolderDataset(data),
                        parametrization="out_in_additive", weight_parts=parts)
    train, loop = _fault_cfgs(tts, tloop, str(tmp_path / "t"),
                              resume_from=path)
    tloop.training_loop(
        loop, train, tconfig.generator_config_from_dict(cfg["g_cfg"]),
        tconfig.discriminator_config_from_dict(cfg["d_cfg"]),
        ImageFolderDataset(data), parametrization="out_in_additive",
        weight_parts=parts, device="cpu")
    assert calls["jax"] == [None] and calls["torch"] == [None]
    for run in ("j", "t"):
        files = set(os.listdir(tmp_path / run))
        assert {"fakes000000.png", "adaptation-000000.npz"} <= files
