"""The port's adaptation CLI (gagan_tpu_torch.cli.adapt), its YAML subset
(utils/yaml_subset.py), the Inferencer and generate / style_mixing
``--s-direction`` against the JAX package's.

Images: Inferencer pairs within the suite's fp32 2e-4 of max|img|; the
CLIs' PNGs within one uint8 level (rounding of values that land on a level
boundary), as tests/test_torch_cli.py holds plain generation.
"""

import glob
import json
import os

import click
import jax
import numpy as np
import PIL.Image
import pytest
import torch
import yaml

from gagan_tpu import inference as jinf
from gagan_tpu.cli import adapt as jadapt
from gagan_tpu.cli import generate as jgen
from gagan_tpu.cli import style_mixing as jmix
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch import entry, inference as tinf
from gagan_tpu_torch.cli import adapt as tadapt
from gagan_tpu_torch.cli import generate as tgen
from gagan_tpu_torch.cli import style_mixing as tmix
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils import yaml_subset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _tiny_g(m):
    return m.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=32,
        mapping=m.MappingConfig(num_layers=2),
        synthesis=m.SynthesisConfig(channel_base=1024, channel_max=64,
                                    packed_last_block=True))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny JAX-written snapshot with non-zero noise strengths, biases and
    w_avg."""
    flat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(4),
                                               _tiny_g(jsg)))
    rng = np.random.RandomState(4)
    for k, v in flat.items():
        if k.endswith("noise_strength"):
            flat[k] = np.float32(rng.uniform(0.05, 0.3))
        elif k.endswith(".bias") and ".affine." not in k:
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("w_avg"):
            flat[k] = (rng.randn(*v.shape) * 0.5).astype(np.float32)
    path = str(tmp_path_factory.mktemp("snap") / "net.npz")
    jck.save_snapshot(path, g_ema=jck.flat_to_tree(flat),
                      config={"g_cfg": jconfig.to_dict(_tiny_g(jsg))})
    return path


def _direction(path, parametrization, seed, scale=0.3, extra=None):
    """An adaptation npz of random offsets (written by the port)."""
    from gagan_tpu.params import offsets as joffs

    cfg = _tiny_g(jsg)
    spec = joffs.OffsetsSpec.from_string(parametrization)
    flat = jck.tree_to_flat(joffs.init_offsets(jax.random.PRNGKey(seed),
                                               cfg.synthesis, spec))
    rng = np.random.RandomState(seed)
    flat = {k: (v + scale * rng.randn(*v.shape)).astype(np.float32)
            for k, v in flat.items()}
    tck.save_adaptation(path, model_type="parametrization",
                        parametrization=parametrization,
                        offsets=tck.flat_to_tree(flat),
                        sg2_config=jconfig.to_dict(cfg), extra_state=extra)
    return path


def _pngs(out):
    return {n: np.asarray(PIL.Image.open(os.path.join(out, n)), np.int16)
            for n in sorted(os.listdir(out))}


def _same_pngs(jout, tout):
    want, got = _pngs(jout), _pngs(tout)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert np.abs(got[name] - want[name]).max() <= 1, name
    return got


# ----------------------------------------------------------------------------
# YAML subset


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_equals_safe_load(path, tmp_path):
    with open(path) as f:
        want = yaml.safe_load(f)
    got = yaml_subset.read(path)
    assert got == want
    out = str(tmp_path / "config.yaml")
    yaml_subset.write(out, got)
    with open(out) as f:
        assert yaml.safe_load(f) == got
    assert yaml_subset.read(out) == got


def test_yaml_subset_scalars_and_limits():
    text = ("a:\n  b: [1, 2.5, 'x, y', \"q\\\"\", null, yes, 1e-3]  # c\n"
            "  c: ~\n  d: {}\n  e: [.inf, 0x1F, -.5]\n  f: Golden Car\n"
            "g: off\n")
    assert yaml_subset.load(text) == yaml.safe_load(text)
    data = {"x": {"y": [1e-05, -0.0, "", " s", "it's", "on", True, None],
                  "z": "a: b #c"}, "w": {}}
    dumped = yaml_subset.dump(data)
    assert yaml_subset.load(dumped) == yaml.safe_load(dumped) == data
    for bad in ("a: &x 1\n", "a: [1, [2]]\n", "a: |\n  t\n", "a: 1\na: 2\n",
                "a:\n- 1\n", "'a': 1\n", "a:\n    b: 1\n  c: 2\n"):
        with pytest.raises(ValueError):
            yaml_subset.load(bad)


# ----------------------------------------------------------------------------
# The CLI


def test_argparse_options_mirror_the_click_command():
    click_opts = {o for p in jadapt.main.params
                  if isinstance(p, click.Option) for o in p.opts}
    ours = {o for a in tadapt.build_parser()._actions
            for o in a.option_strings} - {"-h", "--help"}
    assert ours - click_opts == {"--device"}
    assert click_opts == ours - {"--device"}
    assert jadapt.main.context_settings["allow_extra_args"]


def test_adapt_cli_runs_a_tiny_config(snapshot, tmp_path, monkeypatch):
    monkeypatch.delenv("GAGAN_CLIP_DIR", raising=False)
    out = str(tmp_path / "run")
    overrides = {k: v for k, v in entry.TINY_CLIP.items()}
    trainer = tadapt.main([
        "--config", os.path.join(REPO, "configs", "td_nada_sdelta.yaml"),
        "--network", snapshot, "--outdir", out, "--device", "cpu",
        "training.iter_num=5", "training.batch_size=2",
        "checkpointing.step_backup=4", "logging.log_every=2",
        "training.target_class=Golden Car",
        f"training.clip_config_overrides={overrides!r}"])
    assert sorted(os.listdir(out)) == ["adaptation-000004.npz",
                                       "config.yaml", "losses.jsonl"]
    cfg = yaml_subset.read(os.path.join(out, "config.yaml"))
    with open(os.path.join(out, "config.yaml")) as f:
        assert yaml.safe_load(f) == cfg
    assert cfg["training"]["iter_num"] == 5
    assert cfg["training"]["target_class"] == "Golden Car"
    assert cfg["training"]["clip_config_overrides"] == overrides
    assert cfg["training"]["patch_key"] == "s_delta"
    with open(os.path.join(out, "losses.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["step"] for ln in lines] == [0, 2, 4]
    assert all(np.isfinite(ln["total"]) and "direction_ViT-B-32" in ln
               and "offsets_l2" in ln for ln in lines)
    c = trainer.cfg
    assert (c.lr, c.batch_size, c.iter_num, c.parametrization,
            c.target_class, c.loss.loss_funcs, c.loss.loss_coefs) == (
        0.08, 2, 5, "s_delta", "Golden Car", ("direction", "offsets_l2"),
        (1.0, 0.1))
    ccfg, _ = trainer.clip_encoders["ViT-B/32"]
    assert (ccfg.vision_width, ccfg.vision_layers) == (64, 2)
    # The checkpoint loads in both packages with the trained offsets.
    jmeta, joff, _ = jck.load_adaptation(os.path.join(
        out, "adaptation-000004.npz"))
    assert jmeta["parametrization"] == "s_delta"
    assert sorted(joff) == sorted(_tiny_g(jsg).synthesis.layer_names())
    assert max(float(np.abs(np.asarray(v["offset"])).max())
               for v in joff.values()) > 0


@pytest.mark.parametrize("config,trainer_name", [
    ("im2im_difa", "im2im_difa"), ("im2im_jojo", "im2im_JoJo"),
    ("im2im_mtg", "im2im_single")])
def test_adapt_cli_runs_the_im2im_configs(snapshot, tmp_path, monkeypatch,
                                          config, trainer_name):
    """Each image-driven config for 2 steps at the tiny G: the style PNG
    resized as Pillow's default resize does, projected for 2 steps (random
    VGG16), the random e4e announced for difa_w (at 64^2 here: ``E4E_SIZE``
    is patched for time), the files, moved offsets, an untouched G and
    finite losses."""
    from gagan_tpu_torch.train import adaptation as tad

    monkeypatch.delenv("GAGAN_CLIP_DIR", raising=False)
    monkeypatch.delenv("GAGAN_DETECTOR_DIR", raising=False)
    monkeypatch.setattr(tad, "E4E_SIZE", 64)
    style = np.random.RandomState(9).randint(0, 256, (40, 30, 3), np.uint8)
    style_path = str(tmp_path / "style.png")
    PIL.Image.fromarray(style).save(style_path)
    out = str(tmp_path / "run")
    trainer = tadapt.main([
        "--config", os.path.join(REPO, "configs", f"{config}.yaml"),
        "--network", snapshot, "--outdir", out, "--device", "cpu",
        "training.iter_num=2", "checkpointing.step_backup=2",
        "logging.log_every=1", "inversion.steps=2",
        f"training.target_class={style_path}",
        f"training.clip_config_overrides={dict(entry.TINY_CLIP)!r}"]
        + (["training.clip_layer=1"] if config == "im2im_difa" else []))
    assert trainer.cfg.trainer == trainer_name
    assert sorted(os.listdir(out)) == ["adaptation-000002.npz",
                                       "config.yaml", "losses.jsonl"]
    with open(os.path.join(out, "losses.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["step"] for ln in lines] == [0, 1]
    assert all(np.isfinite(v) for ln in lines for v in ln.values())
    assert ("difa_psp_loss" in lines[0]) == (config == "im2im_difa")
    want = np.array(PIL.Image.fromarray(style).resize((32, 32)))
    got = trainer.style_image[0].numpy().transpose(1, 2, 0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert tuple(trainer.style_latents.shape) == (1, 8, 32)
    _, offsets, _ = tck.load_adaptation(os.path.join(
        out, "adaptation-000002.npz"))
    assert max(float(t.abs().max()) for t in
               tck.tree_to_flat_tensors(offsets).values()) > 0
    trees, _ = tck.load_snapshot(snapshot)
    for k, t in tck.tree_to_flat_tensors(trees["G_ema"]).items():
        assert torch.equal(tck.tree_to_flat_tensors(trainer.g_params)[k], t), k


def test_adapt_cli_refuses(snapshot, tmp_path):
    cfg = os.path.join(REPO, "configs", "td_nada_sdelta.yaml")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tadapt.main(["--config", cfg, "--outdir", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")
    # A configured e4e checkpoint that is missing, before anything loads.
    with pytest.raises(FileNotFoundError, match="e4e_checkpoint"):
        tadapt.main(["--config", os.path.join(REPO, "configs",
                                              "im2im_difa.yaml"),
                     "--device", "cpu", "--outdir", str(tmp_path / "difa"),
                     "inversion.e4e_checkpoint=" + str(tmp_path / "no.npz")])
    assert not os.path.exists(tmp_path / "difa")
    with pytest.raises(ValueError, match="unknown trainer"):
        tadapt.main(["--config", os.path.join(REPO, "configs",
                                              "im2im_jojo.yaml"),
                     "--device", "cpu", "--outdir", str(tmp_path / "jojo"),
                     "exp.trainer=im2im_jojo"])
    with pytest.raises(SystemExit):
        tadapt.main(["--config", cfg, "--device", "cpu", "--bogus"])


def test_adaptation_config_mapping_matches_jax():
    """The config -> AdaptationConfig mapping of both commands, for every
    td_nada config (and difa_w's SCC split on an im2im one)."""
    for path in CONFIGS:
        cfg_dict = yaml_subset.read(path)
        got = tadapt.adaptation_config(cfg_dict)
        opt = cfg_dict["optimization_setup"]
        assert got.lr == opt["lr"]
        funcs = [f for f in opt["loss_funcs"] if f != "difa_w"]
        assert list(got.loss.loss_funcs) == funcs
        assert (got.loss.scc is not None) == ("difa_w" in opt["loss_funcs"])
        assert got.trainer == cfg_dict["exp"]["trainer"]
        assert got.parametrization == cfg_dict["training"]["patch_key"]
        assert got.checkpoint_every == cfg_dict["checkpointing"]["step_backup"]


# ----------------------------------------------------------------------------
# Inferencer and --s-direction


def test_inferencer_matches_jax(snapshot, tmp_path):
    style = np.random.RandomState(5).randn(1, 8, 32).astype(np.float32)
    path = _direction(str(tmp_path / "d.npz"), "s_delta", 6,
                      extra={"style_latents": style})
    jinfer = jinf.Inferencer(path, snapshot)
    tinfer = tinf.Inferencer(path, snapshot, device="cpu")
    z = np.random.RandomState(7).randn(2, 32).astype(np.float32)
    for kw in ({}, {"truncation": 0.7}, {"mtg_mixing": True}):
        want = jinfer(jax.numpy.asarray(z), **kw)
        got = tinfer(z, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=2e-4 * np.abs(np.asarray(w)).max())
    assert not torch.allclose(*tinfer(z))
    ws = np.random.RandomState(8).randn(2, 8, 32).astype(np.float32)
    for g, w in zip(tinfer.from_wplus(ws), jinfer.from_wplus(ws)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4 * np.abs(np.asarray(w)).max())
    with pytest.raises(NotImplementedError, match="item 12"):
        tinf.project_restyle(None)


@pytest.mark.parametrize("parametrization", ["s_delta", "out_in_1_2_additive"])
def test_generate_s_direction_matches_jax(snapshot, tmp_path,
                                          parametrization):
    path = _direction(str(tmp_path / "d.npz"), parametrization, 9)
    args = ["--network", snapshot, "--seeds", "0,1", "--s-direction", path,
            "--s-scale", "0.5"]
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    jgen.main.main(args + ["--outdir", jout], standalone_mode=False)
    tgen.main(args + ["--outdir", tout, "--device", "cpu"])
    got = _same_pngs(jout, tout)
    # --s-scale 0 gives the plain images byte for byte; scale 0.5 differs.
    plain, zero = str(tmp_path / "p"), str(tmp_path / "z")
    tgen.main(["--network", snapshot, "--seeds", "0,1", "--outdir", plain,
               "--device", "cpu"])
    tgen.main(args[:-1] + ["0", "--outdir", zero, "--device", "cpu"])
    for name in ("seed0000.png", "seed0001.png"):
        with open(os.path.join(plain, name), "rb") as a, \
                open(os.path.join(zero, name), "rb") as b:
            assert a.read() == b.read()
        assert not np.array_equal(got[name], _pngs(plain)[name])


def test_style_mixing_directions_match_jax(snapshot, tmp_path):
    a = _direction(str(tmp_path / "a.npz"), "s_delta", 10)
    b = _direction(str(tmp_path / "b.npz"), "s_delta", 11)
    args = ["--network", snapshot, "--rows", "0,1", "--cols", "2",
            "--styles", "0-3", "--s-direction", a, "--s-direction", b,
            "--s-scale", "0.7"]
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    jmix.main.main(args + ["--outdir", jout], standalone_mode=False)
    tmix.main(args + ["--outdir", tout, "--device", "cpu"])
    _same_pngs(jout, tout)
    c = _direction(str(tmp_path / "c.npz"), "additive_w_space", 12)
    with pytest.raises(ValueError, match="parametrization"):
        tmix.main(args[:-2] + ["--s-direction", c, "--outdir", tout,
                               "--device", "cpu"])
