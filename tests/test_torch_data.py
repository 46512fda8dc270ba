"""The port's dataset, sampler and loader (gagan_tpu_torch.data) against the
JAX package's (gagan_tpu.data), item for item: a folder and a zip of PNGs
(RGB and gray), ``dataset.json`` labels, the ``max_size`` subset, xflip, the
sampler's stream and the loader's batches.  Images are uint8 and the index
streams integers: everything must be equal."""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import PIL.Image
import pytest

from gagan_tpu.data import dataset as jds
from gagan_tpu_torch.data import dataset as tds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_folder(d, n=12, res=16, mode="RGB", jpeg=False):
    """n Pillow-written images (Pillow picks the PNG filters) with labels."""
    rng = np.random.RandomState(0)
    os.makedirs(d / "sub", exist_ok=True)
    labels = []
    for i in range(n):
        yy, xx = np.mgrid[0:res, 0:res]
        img = ((yy * 9 + xx * 5 + i * 17)[:, :, None]
               + rng.randint(0, 30, (res, res, 3))) % 256
        img = img.astype(np.uint8)
        name = f"{'sub/' if i % 4 == 3 else ''}img{i:04d}.png"
        pil = PIL.Image.fromarray(img, "RGB").convert(mode)
        pil.save(d / name)
        labels.append([name, i % 3])
    if jpeg:
        PIL.Image.fromarray(img).save(d / "zz.jpg")
    with open(d / "dataset.json", "w") as f:
        json.dump({"labels": labels + ([["zz.jpg", 0]] if jpeg else [])}, f)
    (d / "notes.txt").write_text("not an image")
    return str(d)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return _write_folder(tmp_path_factory.mktemp("rgb"))


@pytest.fixture(scope="module")
def zip_path(folder, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("zip") / "data.zip")
    with zipfile.ZipFile(path, "w") as z:
        for root, _, files in os.walk(folder):
            for f in files:
                full = os.path.join(root, f)
                z.write(full, os.path.relpath(full, folder))
    return path


def _same_items(a, b):
    assert len(a) == len(b)
    assert (a.name, a.image_shape, a.resolution, a.num_channels,
            a.label_shape, a.has_labels) == (
        b.name, b.image_shape, b.resolution, b.num_channels, b.label_shape,
        b.has_labels)
    for i in range(len(a)):
        (ia, la), (ib, lb) = a[i], b[i]
        assert ia.dtype == ib.dtype == np.uint8
        np.testing.assert_array_equal(ia, ib)
        assert la.dtype == lb.dtype
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("kw", [
    {}, {"use_labels": True}, {"xflip": True},
    {"max_size": 5, "random_seed": 3, "xflip": True, "use_labels": True},
    {"max_size": 100}], ids=["plain", "labels", "xflip", "subset", "big"])
@pytest.mark.parametrize("source", ["dir", "zip"])
def test_dataset_matches_jax(source, kw, folder, zip_path):
    path = folder if source == "dir" else zip_path
    _same_items(tds.ImageFolderDataset(path, **kw),
                jds.ImageFolderDataset(path, **kw))


def test_gray_and_other_formats_match_jax(tmp_path):
    path = _write_folder(tmp_path, n=5, mode="L", jpeg=True)
    got = tds.ImageFolderDataset(path, use_labels=True)
    assert got.image_shape == [1, 16, 16]
    assert "zz.jpg" in got._image_fnames           # decoded through Pillow
    _same_items(got, jds.ImageFolderDataset(path, use_labels=True))
    with pytest.raises(IOError, match="resolution"):
        tds.ImageFolderDataset(path, resolution=32)


def test_extension_list_is_pillows():
    PIL.Image.init()
    assert tds.IMAGE_EXTENSIONS == set(PIL.Image.EXTENSION)


def test_non_png_without_pillow_names_the_file(tmp_path):
    path = _write_folder(tmp_path, n=2, jpeg=True)
    code = ("import sys; sys.modules['PIL'] = None\n"
            "from gagan_tpu_torch.data import ImageFolderDataset\n"
            f"ds = ImageFolderDataset({path!r})\n"
            "ds[0]; ds[1]\n"
            "try:\n"
            "    ds[2]\n"
            "except ImportError as e:\n"
            "    print('raised', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "raised zz.jpg" in out.stdout and "Pillow" in out.stdout


@pytest.mark.parametrize("size,seed,window", [(10, 0, 0.5), (37, 5, 0.5),
                                              (8, 1, 0.0)])
def test_sampler_stream_matches_jax(size, seed, window):
    for rank in range(2):
        kw = dict(rank=rank, num_replicas=2, seed=seed, window_size=window)
        a, b = (iter(m.InfiniteSampler(size, **kw)) for m in (tds, jds))
        got = [next(a) for _ in range(200)]
        assert got == [next(b) for _ in range(200)]
        assert set(got) <= set(range(size))


def test_loader_batches_match_jax(folder):
    ds_t = tds.ImageFolderDataset(folder, use_labels=True, xflip=True)
    ds_j = jds.ImageFolderDataset(folder, use_labels=True, xflip=True)
    it_t = tds.data_loader(ds_t, batch_size=5, seed=3, num_workers=2)
    it_j = jds.data_loader(ds_j, batch_size=5, seed=3, num_workers=2)
    for _ in range(4):
        (it_, lt), (ij, lj) = next(it_t), next(it_j)
        assert it_.shape == (5, 3, 16, 16) and lt.shape == (5, 3)
        np.testing.assert_array_equal(it_, ij)
        np.testing.assert_array_equal(lt, lj)
    it_t.close()
    it_j.close()


def test_loader_to_device_and_errors(folder, tmp_path):
    it = tds.data_loader(tds.ImageFolderDataset(folder), batch_size=3,
                         num_workers=1,
                         to_device=lambda b: ("moved", b[0].shape))
    assert next(it) == ("moved", (3, 3, 16, 16))
    it.close()

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError("bad file")

    it = tds.data_loader(Broken(), batch_size=2, num_workers=1)
    with pytest.raises(OSError, match="bad file"):
        next(it)
    it.close()
