"""The port's generate CLI against the JAX package's on one snapshot written
by the JAX package: the same seeds give PNGs within one uint8 level."""

import os

import numpy as np
import PIL.Image
import pytest
import torch

from gagan_tpu.cli import generate as jgen
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch.cli import generate as tgen
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A 256x256 snapshot (pallas_level on, so b128.conv1 takes the fused
    level) with non-zero noise strengths, biases and w_avg."""
    def build(m):
        return m.GeneratorConfig(
            z_dim=64, w_dim=64, img_resolution=256,
            mapping=m.MappingConfig(num_layers=2),
            synthesis=m.SynthesisConfig(channel_base=16384, channel_max=128,
                                        conv_clamp=256, packed_last_block=True,
                                        pallas_level=True))
    flat = tck.tree_to_flat(tsg.init_generator(
        build(tsg), torch.Generator().manual_seed(5), "cpu"))
    rng = np.random.RandomState(5)
    for k, v in flat.items():
        if k.endswith("noise_strength"):
            flat[k] = np.float32(rng.uniform(0.05, 0.3))
        elif k.startswith("synthesis") and k.endswith(".bias") \
                and ".affine." not in k:
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("w_avg"):
            flat[k] = (rng.randn(*v.shape) * 0.5).astype(np.float32)
    path = str(tmp_path_factory.mktemp("snap") / "net.npz")
    jck.save_snapshot(path, g_ema=jck.flat_to_tree(flat),
                      config={"g_cfg": jconfig.to_dict(build(jsg))})
    return path


def test_generate_matches_jax_cli(snapshot, tmp_path):
    args = ["--network", snapshot, "--seeds", "0,1", "--trunc", "0.7",
            "--noise-mode", "const"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jgen.main.main(args + ["--outdir", jout], standalone_mode=False)
    tgen.main(args + ["--outdir", tout, "--device", "cpu"])
    names = ["seed0000.png", "seed0001.png"]
    assert sorted(os.listdir(tout)) == names
    for name in names:
        want = np.asarray(PIL.Image.open(os.path.join(jout, name)), np.int16)
        got = np.asarray(PIL.Image.open(os.path.join(tout, name)), np.int16)
        assert got.shape == want.shape == (256, 256, 3)
        assert np.abs(got - want).max() <= 1, name
        assert got.std() > 0


def test_write_png_round_trips_through_pil(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (7, 5, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    tgen.write_png(path, img)
    got = PIL.Image.open(path)
    assert got.mode == "RGB"
    assert np.array_equal(np.asarray(got), img)


def test_cli_without_cuda_refuses_default_device(snapshot, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgen.main(["--network", snapshot, "--seeds", "0",
                   "--outdir", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")
