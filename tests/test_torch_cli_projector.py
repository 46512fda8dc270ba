"""The port's projector command (gagan_tpu_torch/cli/projector.py) on the CPU:
its options against the JAX click command's, the files it writes for a
tiny snapshot and PNG targets, and its target loading (centre crop, then
Lanczos-3 resize) against Pillow's LANCZOS, within one uint8 level (Pillow
rounds each pass in fixed point)."""

import os
import sys

import numpy as np
import PIL.Image
import pytest
import torch

from gagan_tpu.cli import projector as jproj_cli
from gagan_tpu_torch.cli import projector as tproj_cli
from gagan_tpu_torch.data.dataset import read_rgb
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.ops.resize import resize_uint8
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils.config import to_dict
from gagan_tpu_torch.utils.png import read_png, write_png

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    cfg = tsg.GeneratorConfig(
        z_dim=16, w_dim=16, img_resolution=16,
        mapping=tsg.MappingConfig(num_layers=2),
        synthesis=tsg.SynthesisConfig(channel_base=256, channel_max=32))
    params = tsg.init_generator(cfg, torch.Generator().manual_seed(0), "cpu")
    path = str(tmp_path_factory.mktemp("snap") / "net.npz")
    tck.save_snapshot(path, g_ema=params, config={"g_cfg": to_dict(cfg)})
    return path


def test_argparse_options_mirror_the_click_command():
    import click

    click_opts = {o for p in jproj_cli.main.params
                  if isinstance(p, click.Option) for o in p.opts}
    ours = {o for a in tproj_cli.build_parser()._actions
            for o in a.option_strings} - {"-h", "--help"}
    assert ours - click_opts == {"--device"}
    assert click_opts == ours - {"--device"}


@pytest.mark.parametrize("size,res", [((40, 24), 16), ((13, 29), 16),
                                      ((64, 64), 16), ((10, 12), 32),
                                      ((16, 16), 16)])
def test_load_targets_match_pillow(tmp_path, size, res):
    """_load_targets' crop and Lanczos resize against the JAX command's
    Pillow calls, on an RGB and a gray+alpha PNG."""
    h, w = size
    rng = np.random.RandomState(h * 100 + w)
    for name, img in (("rgb.png", rng.randint(0, 256, (h, w, 3), np.uint8)),
                      ("la.png", rng.randint(0, 256, (h, w, 2), np.uint8))):
        path = str(tmp_path / name)
        PIL.Image.fromarray(img, "RGB" if img.shape[2] == 3 else "LA").save(
            path)
        want = dict(jproj_cli._load_targets(path, res))[path]
        got = dict(tproj_cli._load_targets(path, res))[path]
        assert got.shape == want.shape == (res, res, 3)
        assert got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name


def test_resize_uint8_matches_pillow_bicubic():
    """The adapt command's style image resize: Pillow's default resample
    (bicubic) in both directions."""
    rng = np.random.RandomState(1)
    for (h, w), out in (((50, 37), (32, 32)), ((20, 20), (64, 64)),
                        ((128, 96), (32, 32))):
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        want = np.array(PIL.Image.fromarray(img).resize(out[::-1]))
        got = resize_uint8(img, out, "bicubic")
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_read_rgb_without_pillow_names_the_fix(tmp_path, monkeypatch):
    img = np.random.RandomState(2).randint(0, 256, (8, 8, 3), np.uint8)
    PIL.Image.fromarray(img).save(str(tmp_path / "a.jpg"))
    PIL.Image.fromarray(img).convert("P").save(str(tmp_path / "p.png"))
    assert read_rgb(str(tmp_path / "a.jpg")).shape == (8, 8, 3)
    np.testing.assert_array_equal(
        read_rgb(str(tmp_path / "p.png")),
        np.array(PIL.Image.open(str(tmp_path / "p.png")).convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for name in ("a.jpg", "p.png"):
        with pytest.raises(ImportError, match="convert the image to an 8-bit "
                                              "PNG"):
            read_rgb(str(tmp_path / name))


def test_projector_command_writes_its_files(snapshot, tmp_path, monkeypatch):
    monkeypatch.delenv("GAGAN_DETECTOR_DIR", raising=False)
    targets = tmp_path / "targets"
    (targets / "sub").mkdir(parents=True)
    rng = np.random.RandomState(3)
    write_png(str(targets / "a.png"), rng.randint(0, 256, (20, 24, 3),
                                                   np.uint8))
    write_png(str(targets / "sub" / "b.png"), rng.randint(0, 256, (16, 16, 3),
                                                          np.uint8))
    out = tmp_path / "out"
    results = tproj_cli.main([
        "--network", snapshot, "--target", str(targets), "--outdir", str(out),
        "--space", "w", "--num-steps", "3", "--save-image",
        "--save-all-steps", "--save-n", "2", "--device", "cpu"])
    assert [os.path.basename(f) for f, _, _ in results] == ["a.png", "b.png"]
    assert all(len(d) == 3 and np.all(np.isfinite(d)) for _, _, d in results)
    with np.load(out / "projected_w.npz") as f:
        w = f["w"]
    assert w.shape == (2, 6, 16) and np.all(np.isfinite(w))
    for stem in ("a", "b"):
        assert read_png(str(out / f"{stem}_proj.png")).shape == (16, 16, 3)
        assert read_png(str(out / f"{stem}_target.png")).shape == (16, 16, 3)
        with np.load(out / f"{stem}_steps.npz") as f:
            assert f["w"].shape == (3, 16)
        assert sorted(os.listdir(out / f"{stem}_steps")) == [
            "step00000.png", "step00002.png"]
    # W+ rows are the one projected w, repeated.
    assert np.all(w[:, 1:] == w[:, :1])
    z = tproj_cli.main([
        "--network", snapshot, "--target", str(targets / "a.png"),
        "--outdir", str(tmp_path / "z"), "--space", "z", "--num-steps", "2",
        "--device", "cpu"])
    assert z[0][1].shape == (6, 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tproj_cli.main(["--network", snapshot, "--target",
                            str(targets), "--outdir", str(out), "--space",
                            "w"])
