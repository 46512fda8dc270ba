"""The port's dataset tool (gagan_tpu_torch.data.dataset_tool), its LMDB
reader and ``ImagesDataset`` against the JAX package's, which call Pillow,
on the CPU.

For each source a test can build here (an image folder, a zip, an LMDB
written with ``tests/test_data.py``'s page helpers, an MNIST idx-ubyte gz
pair and a CIFAR-10 python tarball) and each transform (scale, center-crop,
center-crop-wide; LANCZOS and BOX), both tools convert the same input and
their zips must hold the same file names, equal decoded pixels and an equal
``dataset.json``.  The PNG bytes differ (each tool has its own encoder);
the pixels may differ by at most 1 level only where a resize rounds, and
the port's resizes compute Pillow's fixed-point coefficients and rounding,
so they are held equal everywhere.
"""

import gzip
import io
import json
import os
import pickle
import tarfile
import zipfile

import numpy as np
import PIL.Image
import pytest

from gagan_tpu.data import dataset_tool as jtool
from gagan_tpu.data import lmdb_reader as jlmdb
from gagan_tpu.data import style_dataset as jstyle
from gagan_tpu_torch.data import dataset_tool as ttool
from gagan_tpu_torch.data import lmdb_reader as tlmdb
from gagan_tpu_torch.data import style_dataset as tstyle
from gagan_tpu_torch.utils.png import read_png

from .test_data import _lmdb_leaf_page, _lmdb_meta_page


def _save(img, path, fmt="png"):
    PIL.Image.fromarray(img).save(path, format=fmt)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("sources")
    rng = np.random.RandomState(0)
    base = [rng.randint(0, 256, (6, 5, 3)).astype(np.uint8) for _ in range(4)]
    imgs = [np.asarray(PIL.Image.fromarray(b).resize((20, 24),
                                                     PIL.Image.BICUBIC))
            for b in base]
    out = {}
    folder = root / "folder"
    (folder / "sub").mkdir(parents=True)
    labels = []
    for i, img in enumerate(imgs):
        name = f"{'sub/' if i % 2 else ''}img{i}.png"
        _save(img, folder / name)
        labels.append([name, i % 3])
    (folder / "dataset.json").write_text(json.dumps({"labels": labels}))
    out["folder"] = str(folder)

    zpath = root / "src.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for i, img in enumerate(imgs):
            buf = io.BytesIO()
            PIL.Image.fromarray(img).save(buf, format="png")
            z.writestr(f"a/img{i}.png", buf.getvalue())
    out["zip"] = str(zpath)

    items = []
    for i, img in enumerate(imgs[:3]):
        buf = io.BytesIO()
        PIL.Image.fromarray(img).save(buf, format="png")
        items.append((f"key{i}".encode(), buf.getvalue()))
    psize = 4096
    blob = (_lmdb_meta_page(psize, 1, root=2, entries=3, depth=1)
            + _lmdb_meta_page(psize, 0, root=2, entries=3, depth=1)
            + _lmdb_leaf_page(psize, 2, items))
    (root / "lsun").mkdir()
    (root / "lsun" / "data.mdb").write_bytes(bytes(blob))
    out["lmdb"] = str(root / "lsun")

    mimgs = rng.randint(0, 256, (5, 28, 28), dtype=np.uint8)
    mlabels = rng.randint(0, 9, (5,), dtype=np.uint8)
    img_gz = root / "train-images-idx3-ubyte.gz"
    with gzip.open(img_gz, "wb") as f:
        f.write(b"\x00" * 16 + mimgs.tobytes())
    with gzip.open(root / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(b"\x00" * 8 + mlabels.tobytes())
    out["mnist"] = str(img_gz)

    tar_path = root / "cifar-10-python.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tar:
        for b in range(1, 6):
            data = {"data": rng.randint(0, 256, (2, 3072), dtype=np.uint8),
                    "labels": [int(v) for v in rng.randint(0, 10, 2)]}
            payload = pickle.dumps(data)
            info = tarfile.TarInfo(f"cifar-10-batches-py/data_batch_{b}")
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    out["cifar"] = str(tar_path)
    return out


def _zip_contents(path):
    with zipfile.ZipFile(path) as z:
        names = sorted(z.namelist())
        meta = json.loads(z.read("dataset.json"))
        pixels = {n: read_png(z.read(n)) for n in names if n.endswith(".png")}
    return names, meta, pixels


CASES = [
    # (source, transform, width, height, resize filter)
    ("folder", None, 16, 16, "lanczos"),
    ("folder", "center-crop", 16, 16, "lanczos"),
    ("folder", "center-crop", 8, 8, "box"),
    ("folder", "center-crop-wide", 16, 8, "lanczos"),
    ("zip", None, 16, 16, "box"),
    ("zip", "center-crop", 16, 16, "lanczos"),
    ("lmdb", "center-crop", 16, 16, "lanczos"),
    ("lmdb", "center-crop-wide", 16, 8, "box"),
    ("mnist", None, None, None, "lanczos"),
    ("mnist", None, 16, 16, "box"),
    ("cifar", None, None, None, "lanczos"),
    ("cifar", "center-crop", 16, 16, "lanczos"),
    ("cifar", "center-crop-wide", 32, 16, "box"),
]


@pytest.mark.parametrize("source,transform,width,height,resize_filter",
                         CASES)
def test_dataset_tool_matches_jax(sources, tmp_path, source, transform,
                                  width, height, resize_filter):
    kw = dict(transform=transform, width=width, height=height,
              resize_filter=resize_filter, max_images=None)
    jdest, tdest = str(tmp_path / "jax.zip"), str(tmp_path / "torch.zip")
    jtool.convert_dataset(sources[source], jdest, **kw)
    ttool.convert_dataset(sources[source], tdest, **kw)
    jn, jm, jp = _zip_contents(jdest)
    tn, tm, tp = _zip_contents(tdest)
    assert tn == jn and tm == jm and len(tp) > 0
    for name in jp:
        np.testing.assert_array_equal(tp[name], jp[name])


def test_dataset_tool_cli_and_max_images(sources, tmp_path):
    """The argparse command with the click command's options."""
    dest = str(tmp_path / "out.zip")
    ttool.main(["--source", sources["folder"], "--dest", dest,
                "--max-images", "2", "--transform", "center-crop",
                "--width", "8", "--height", "8", "--resize-filter", "box"])
    jdest = str(tmp_path / "jax.zip")
    jtool.convert_dataset(sources["folder"], jdest, max_images=2,
                          transform="center-crop", width=8, height=8,
                          resize_filter="box")
    tn, tm, tp = _zip_contents(dest)
    jn, jm, jp = _zip_contents(jdest)
    assert tn == jn and tm == jm and len(tp) == 2
    for name in jp:
        np.testing.assert_array_equal(tp[name], jp[name])
    with pytest.raises(SystemExit):
        ttool.convert_dataset(sources["folder"], str(tmp_path / "x.zip"),
                              width=12, height=12)   # not a power of two


def test_tool_writes_pillow_filter_choice(sources, tmp_path):
    """The port's encoder picks each row's filter as Pillow does: the
    rows of its PNGs carry Sub and Paeth filters as Pillow's do."""
    dest = str(tmp_path / "out.zip")
    ttool.convert_dataset(sources["folder"], dest, width=16, height=16)
    import struct
    import zlib

    with zipfile.ZipFile(dest) as z:
        data = z.read(sorted(n for n in z.namelist() if n.endswith(".png"))[0])
    pos, idat = 8, b""
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    types = {raw[i * (16 * 3 + 1)] for i in range(16)}
    assert types <= {0, 1, 2, 3, 4} and 4 in types


def test_lmdb_reader_matches_jax(sources):
    path = sources["lmdb"]
    assert list(tlmdb.LMDBReader(path)) == list(jlmdb.LMDBReader(path))
    assert len(tlmdb.LMDBReader(path)) == 3


@pytest.mark.parametrize("size", [32, 512])
def test_images_dataset_matches_jax(tmp_path, size):
    """The same records: Pillow's default resize (BICUBIC) to ``size``,
    then LANCZOS to 256^2, as uint8 and [-1, 1] CHW floats."""
    rng = np.random.RandomState(size)
    for i in range(2):
        base = rng.randint(0, 256, (9, 7, 3)).astype(np.uint8)
        _save(np.asarray(PIL.Image.fromarray(base).resize((70, 90))),
              tmp_path / f"s{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    tds = tstyle.ImagesDataset(size, str(tmp_path))
    jds = jstyle.ImagesDataset(size, str(tmp_path))
    assert len(tds) == len(jds) == 2
    assert tstyle.make_dataset(str(tmp_path)) == jstyle.make_dataset(
        str(tmp_path))
    for i in range(2):
        t, j = tds[i], jds[i]
        assert sorted(t) == sorted(j) and t["image_name"] == j["image_name"]
        for k in ("image_high_res", "image_low_res", "image_high_res_t",
                  "image_low_res_t"):
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
    assert tstyle.is_image_file("a.JPG") and not tstyle.is_image_file("a.gif")
    with pytest.raises(ValueError):
        tstyle.ImagesDataset(size, str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="landmark_fn"):
        tstyle.ImagesDataset(size, str(tmp_path), align_input=True)


def test_images_dataset_aligned_matches_jax(tmp_path):
    """align_input with a landmark function: the FFHQ alignment (at the
    dataset's size, transform 4096 as the JAX dataset calls it) within 1
    level (tests/test_torch_face.py argues the bound)."""
    rng = np.random.RandomState(3)
    base = rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
    _save(np.asarray(PIL.Image.fromarray(base).resize((128, 128),
                                                      PIL.Image.BICUBIC)),
          tmp_path / "face.png")
    lm = np.array([[40.2, 50.3], [80.7, 48.9], [61.0, 72.4], [45.5, 95.1],
                   [78.3, 94.0]])
    tds = tstyle.ImagesDataset(64, str(tmp_path / "face.png"),
                               align_input=True, landmark_fn=lambda im: lm,
                               device="cpu")
    jds = jstyle.ImagesDataset(64, str(tmp_path / "face.png"),
                               align_input=True, landmark_fn=lambda im: lm)
    t, j = tds[0], jds[0]
    for k in ("image_high_res", "image_low_res"):
        assert t[k].shape == j[k].shape
        assert np.abs(t[k].astype(int) - j[k].astype(int)).max() <= 1
