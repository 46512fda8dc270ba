"""The port's training, generate and style-mixing commands against the JAX
package's click commands: every option with the same destination, default,
choices and flag-ness; ``--dry-run`` prints the same run name and plan JSON
at 32^2 and 1024^2; the spec -> configs arithmetic equals the JAX command's
configs; generate ``--projected-w`` / ``--class`` and style mixing give the
JAX command's PNGs within one uint8 level (const noise); a short run through
the command end to end; the options the port refuses."""

import argparse
import dataclasses
import json
import os

import click
import numpy as np
import PIL.Image
import pytest
import torch

from gagan_tpu.cli import generate as jgen
from gagan_tpu.cli import style_mixing as jmix
from gagan_tpu.cli import train as jtrain
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch.cli import generate as tgen
from gagan_tpu_torch.cli import num_range
from gagan_tpu_torch.cli import style_mixing as tmix
from gagan_tpu_torch.cli import train as ttrain
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.train import loop as tloop
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils import config as tconfig
from gagan_tpu_torch.utils.png import read_png, write_png

torch.set_num_threads(2)

TYPES = {"integer": int, "float": float, "text": None, "choice": None,
         "boolean": None, "num_range": num_range}


def _default(opt):
    """A click option's default, None where click marks it unset."""
    d = opt.default
    return None if type(d).__name__ == "Sentinel" else d


def _parser_of(main):
    """The argparse parser a port command builds (captured at parse)."""
    if main is ttrain.main:
        return ttrain.build_parser()
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        seen["p"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["p"]


@pytest.mark.parametrize("jcmd,tmain", [
    (jtrain.main, ttrain.main), (jgen.main, tgen.main),
    (jmix.main, tmix.main)], ids=["train", "generate", "style_mixing"])
def test_options_match_the_click_command(jcmd, tmain):
    actions = {s: a for a in _parser_of(tmain)._actions
               for s in a.option_strings}
    options = [p for p in jcmd.params if isinstance(p, click.Option)]
    assert len(options) >= 4
    for opt in options:
        flag = next(o for o in opt.opts if o.startswith("--"))
        act = actions.get(flag)
        assert act is not None, flag
        assert act.dest == opt.name, flag
        assert act.required == bool(opt.required), flag
        if opt.is_flag:
            assert isinstance(act, argparse._StoreTrueAction), flag
            continue
        if opt.multiple:
            assert isinstance(act, argparse._AppendAction), flag
            assert tuple(act.default or ()) == tuple(_default(opt) or ()), flag
        else:
            assert act.default == _default(opt), flag
        if isinstance(opt.type, click.Choice):
            assert list(act.choices) == list(opt.type.choices), flag
        else:
            assert act.choices is None, flag
            assert act.type is TYPES[opt.type.name], flag
    extra = set(actions) - {o for p in options for o in p.opts}
    assert extra == {"-h", "--help", "--device"}


def _folder(path, res, n=3):
    os.makedirs(path, exist_ok=True)
    yy, xx = np.mgrid[0:res, 0:res]
    for i in range(n):
        img = np.stack([(yy + i) % 256, xx % 256, (yy + xx) % 256], -1)
        write_png(os.path.join(path, f"{i:03d}.png"), img.astype(np.uint8))
    return str(path)


DRY_RUNS = {
    "auto": [],
    "batch": ["--batch", "32", "--kimg", "5", "--gamma", "3", "--mirror"],
    "alternating": ["--phase-schedule", "alternating", "--glrate", "0.001",
                    "--generator-requires-grad-parts", "synt_affine,tRGB"],
    "batch_gpu": ["--cfg", "paper1024", "--batch-gpu", "4"],
    "fixed": ["--cfg", "stylegan2", "--aug", "fixed", "--p", "0.3",
              "--packed-tail-blocks", "0", "--subset", "2"],
}


@pytest.mark.parametrize("res", [32, 1024])
@pytest.mark.parametrize("name", sorted(DRY_RUNS))
def test_dry_run_plan_matches_jax(res, name, tmp_path, capsys):
    data = _folder(tmp_path / f"data{res}", res, n=2)
    args = ["--outdir", str(tmp_path / "o"), "--data", data, "--gpus", "1",
            "--dry-run"] + DRY_RUNS[name]
    jtrain.main.main(args, standalone_mode=False)
    want = capsys.readouterr().out
    assert ttrain.main(args + ["--device", "cpu"]) is None
    got = capsys.readouterr().out
    assert got == want
    assert '"accum_rounds"' in got and "Dry run" in got
    assert not os.path.exists(tmp_path / "o")


@pytest.mark.parametrize("res,kw", [
    (1024, dict(batch=32)), (512, {}), (256, dict(cond=True, label_dim=5)),
    (64, dict(aug="noaug", packed_head_blocks=0, ga_threshold=0.3)),
    (1024, dict(batch=64, batch_gpu=32, aug_dtype="float32"))],
    ids=["1024", "512", "256cond", "64", "1024wide"])
def test_build_run_configs_match_jax(res, kw, monkeypatch):
    """G (but pallas_level, which the port turns on), D, train, augment and
    loop configs equal what the JAX command hands its training loop."""
    label_dim = kw.pop("label_dim", 0)
    seen = {}

    def fake_loop(loop_cfg, train_cfg, g_cfg, d_cfg, dataset, **k):
        seen.update(loop=loop_cfg, train=train_cfg, g=g_cfg, d=d_cfg, **k)

    class FakeDataset:
        name, resolution, num_channels = "fake", res, 3

        def __init__(self, *a, **k):
            self.label_dim = label_dim

    monkeypatch.setattr(jtrain, "__name__", jtrain.__name__)
    import gagan_tpu.data as jdata
    import gagan_tpu.train.loop as jloop_mod
    monkeypatch.setattr(jdata, "ImageFolderDataset", FakeDataset)
    monkeypatch.setattr(jloop_mod, "training_loop", fake_loop)
    flags = []
    for k, v in kw.items():
        flags += ([f"--{k.replace('_', '-')}"] if v is True
                  else [f"--{k.replace('_', '-')}", str(v)])
    jtrain.main.main(["--outdir", "o", "--data", "d", "--gpus", "1"] + flags,
                     standalone_mode=False)
    run = ttrain.build_run(res, 3, label_dim, outdir="o", n_devices=1, **kw)
    g = dataclasses.replace(run.g_cfg, synthesis=dataclasses.replace(
        run.g_cfg.synthesis, pallas_level=False))
    assert jconfig.generator_config_from_dict(tconfig.to_dict(g)) == seen["g"]
    assert jconfig.discriminator_config_from_dict(
        tconfig.to_dict(run.d_cfg)) == seen["d"]
    assert dataclasses.asdict(run.train_cfg) == dataclasses.asdict(
        seen["train"])
    want_aug = seen["augment_cfg"]
    assert (None if run.augment_cfg is None
            else dataclasses.asdict(run.augment_cfg)) == (
        None if want_aug is None else dataclasses.asdict(want_aug))
    assert dataclasses.asdict(run.loop_cfg) == dataclasses.asdict(seen["loop"])
    assert run.reg_remat == seen["reg_remat"]
    assert run.parts == seen["weight_parts"]
    assert run.g_cfg.synthesis.pallas_level


@pytest.mark.parametrize("flags,match", [
    (["--gpus", "2"], "item 10"), (["--spatial-shard-min-res", "8"], "item 10"),
    (["--use-domain-modulation"], "item 11"),
    (["--packed-tail-blocks", "2"], "tail")])
def test_train_refuses_unported_options(flags, match, tmp_path):
    data = _folder(tmp_path / "d", 16)
    with pytest.raises(NotImplementedError, match=match):
        ttrain.main(["--outdir", str(tmp_path / "o"), "--data", data,
                     "--dry-run"] + flags)
    with pytest.raises(SystemExit):                     # 4 % 3 != 0
        ttrain.main(["--outdir", str(tmp_path / "o"), "--data", data,
                     "--batch", "4", "--batch-gpu", "3", "--dry-run"])


def test_train_command_runs_end_to_end(tmp_path, monkeypatch):
    """Two batches at 16^2 through the command: it ends, and writes the
    stats line, the grid and a snapshot that generate reads back."""
    orig = tloop.training_loop

    def short(loop_cfg, *a, **k):
        loop_cfg.total_kimg = 0.008
        loop_cfg.kimg_per_tick = 0.008
        return orig(loop_cfg, *a, **k)

    monkeypatch.setattr(tloop, "training_loop", short)
    data = _folder(tmp_path / "d", 16, n=5)
    out = str(tmp_path / "run")
    state = ttrain.main(["--outdir", out, "--data", data, "--gpus", "1",
                         "--cfg", "auto", "--batch", "4", "--kimg", "1",
                         "--aug", "ada", "--augpipe", "bgc", "--snap", "1",
                         "--seed", "0", "--device", "cpu"])
    assert state.cur_nimg == 8
    with open(os.path.join(out, "stats.jsonl")) as f:
        line = json.loads(f.readline())
    assert line["Progress/kimg"] == 0.008 and 0 <= line["Progress/augment"] <= 1
    assert np.isfinite(line["Loss/G/loss"]) and np.isfinite(line["Loss/D/loss"])
    assert read_png(os.path.join(out, "fakes000000.png")).shape == (64, 64, 3)
    snap = os.path.join(out, "network-snapshot-000000.npz")
    tgen.main(["--network", snap, "--seeds", "1", "--outdir",
               str(tmp_path / "g"), "--device", "cpu"])
    assert read_png(str(tmp_path / "g" / "seed0001.png")).shape == (16, 16, 3)


@pytest.fixture(scope="module")
def cond_snapshot(tmp_path_factory):
    """A 32x32 conditional snapshot (c_dim 4) written by the JAX package,
    with non-zero noise strengths, biases and w_avg."""
    def build(m):
        return m.GeneratorConfig(
            z_dim=32, w_dim=32, c_dim=4, img_resolution=32,
            mapping=m.MappingConfig(num_layers=2),
            synthesis=m.SynthesisConfig(channel_base=1024, channel_max=64,
                                        conv_clamp=256))
    import jax

    flat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(3),
                                               build(jsg)))
    rng = np.random.RandomState(5)
    for k, v in flat.items():
        if k.endswith("noise_strength"):
            flat[k] = np.float32(rng.uniform(0.05, 0.3))
        elif k.endswith(".bias") and ".affine." not in k:
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("w_avg"):
            flat[k] = (rng.randn(*v.shape) * 0.5).astype(np.float32)
    path = str(tmp_path_factory.mktemp("snap") / "net.npz")
    jck.save_snapshot(path, g_ema=jck.flat_to_tree(flat),
                      config={"g_cfg": jconfig.to_dict(build(jsg))})
    return path


def _same_pngs(jdir, tdir, names):
    assert sorted(os.listdir(tdir)) == sorted(names)
    for name in names:
        want = np.asarray(PIL.Image.open(os.path.join(jdir, name)), np.int16)
        got = read_png(os.path.join(tdir, name)).astype(np.int16)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1, name
        assert got.std() > 0


def test_generate_class_and_projected_w_match_jax(cond_snapshot, tmp_path):
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    args = ["--network", cond_snapshot, "--seeds", "0,2", "--class", "1",
            "--trunc", "0.8"]
    jgen.main.main(args + ["--outdir", jout], standalone_mode=False)
    tgen.main(args + ["--outdir", tout, "--device", "cpu"])
    _same_pngs(jout, tout, ["seed0000.png", "seed0002.png"])

    ws = np.random.RandomState(7).randn(2, 8, 32).astype(np.float32)
    wpath = str(tmp_path / "w.npz")
    np.savez(wpath, w=ws)
    args = ["--network", cond_snapshot, "--projected-w", wpath]
    jgen.main.main(args + ["--outdir", jout + "p"], standalone_mode=False)
    tgen.main(args + ["--outdir", tout + "p", "--device", "cpu"])
    _same_pngs(jout + "p", tout + "p", ["proj00.png", "proj01.png"])

    with pytest.raises(SystemExit):                      # no --class
        tgen.main(["--network", cond_snapshot, "--seeds", "0", "--outdir",
                   tout, "--device", "cpu"])
    # With a StyleSpace direction (offsets hooks), as the JAX CLI applies it.
    direction = _s_delta_direction(str(tmp_path / "d.npz"), cond_snapshot)
    extra = ["--s-direction", direction, "--s-scale", "2"]
    jgen.main.main(args + extra + ["--outdir", jout + "d"],
                   standalone_mode=False)
    tgen.main(args + extra + ["--outdir", tout + "d", "--device", "cpu"])
    _same_pngs(jout + "d", tout + "d", ["proj00.png", "proj01.png"])
    assert not np.array_equal(read_png(os.path.join(tout + "d", "proj00.png")),
                              read_png(os.path.join(tout + "p", "proj00.png")))


def _s_delta_direction(path, snapshot):
    """An s_delta adaptation npz of random offsets for the snapshot's G."""
    _, config = jck.load_snapshot(snapshot)
    g_cfg = tconfig.generator_config_from_dict(config["g_cfg"])
    rng = np.random.RandomState(6)
    offsets = {name: {"offset": (0.3 * rng.randn(1, ch)).astype(np.float32)}
               for name, ch in zip(g_cfg.synthesis.layer_names(),
                                   g_cfg.synthesis.layer_in_channels())}
    jck.save_adaptation(path, model_type="parametrization",
                        parametrization="s_delta", offsets=offsets,
                        sg2_config=config["g_cfg"])
    return path


def test_generate_random_noise_is_per_seed(cond_snapshot, tmp_path):
    out = str(tmp_path / "r")
    for sub in ("a", "b"):
        tgen.main(["--network", cond_snapshot, "--seeds", "3,4", "--class",
                   "0", "--noise-mode", "random", "--outdir",
                   os.path.join(out, sub), "--device", "cpu"])
    a3, b3, a4 = (read_png(os.path.join(out, s, f"seed000{n}.png"))
                  for s, n in (("a", 3), ("b", 3), ("a", 4)))
    assert np.array_equal(a3, b3) and not np.array_equal(a3, a4)


@pytest.fixture(scope="module")
def uncond_snapshot(tmp_path_factory):
    def build(m):
        return m.GeneratorConfig(
            z_dim=32, w_dim=32, img_resolution=32,
            mapping=m.MappingConfig(num_layers=2),
            synthesis=m.SynthesisConfig(channel_base=1024, channel_max=64))
    import jax

    flat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(4),
                                               build(jsg)))
    flat = {k: (np.float32(0.2) if k.endswith("noise_strength") else v)
            for k, v in flat.items()}
    path = str(tmp_path_factory.mktemp("snap") / "net.npz")
    jck.save_snapshot(path, g_ema=jck.flat_to_tree(flat),
                      config={"g_cfg": jconfig.to_dict(build(jsg))})
    return path


def test_style_mixing_matches_jax(uncond_snapshot, tmp_path):
    args = ["--network", uncond_snapshot, "--rows", "0,1", "--cols", "2",
            "--styles", "0-3", "--trunc", "0.9"]
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    jmix.main.main(args + ["--outdir", jout], standalone_mode=False)
    tmix.main(args + ["--outdir", tout, "--device", "cpu"])
    names = ["0-0.png", "1-1.png", "2-2.png", "0-2.png", "1-2.png",
             "grid.png"]
    _same_pngs(jout, tout, names)
    assert read_png(os.path.join(tout, "grid.png")).shape == (96, 64, 3)
    # With a StyleSpace direction, as the JAX CLI applies it.
    extra = ["--s-direction", _s_delta_direction(str(tmp_path / "d.npz"),
                                                 uncond_snapshot)]
    jmix.main.main(args + extra + ["--outdir", jout + "d"],
                   standalone_mode=False)
    tmix.main(args + extra + ["--outdir", tout + "d", "--device", "cpu"])
    _same_pngs(jout + "d", tout + "d", names)
