"""The port's native zip loader (gagan_tpu_torch.data.native_loader over its
own zlib-only ``csrc/gagan_loader.cpp``) against its ``ImageFolderDataset``
and against the JAX package's ``NativeZipDataset``, on the same zip.

The library is built with ``g++`` and zlib; without them here the tests skip
with the build error.  Equality is exact: both read the same lossless PNGs.
"""

import io
import json
import struct
import zipfile
import zlib

import numpy as np
import PIL.Image
import pytest

from gagan_tpu.data import native_loader as jnl
from gagan_tpu_torch.data import ImageFolderDataset, data_loader
from gagan_tpu_torch.data import dataset_tool as ttool
from gagan_tpu_torch.data import native_loader as tnl
from gagan_tpu_torch.utils.png import encode_png


@pytest.fixture(scope="module")
def built():
    if not tnl.native_available():
        pytest.skip(f"the native loader does not build here: "
                    f"{tnl.build_error()}")


@pytest.fixture(scope="module")
def data_zip(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(0)
    labels = []
    for i in range(20):
        base = rng.randint(0, 255, (8, 8, 3), dtype=np.uint8)
        img = np.asarray(PIL.Image.fromarray(base).resize(
            (32, 32), PIL.Image.BICUBIC))
        name = f"img{i:04d}.png"
        PIL.Image.fromarray(img).save(d / name)
        labels.append([name, i % 4])
    (d / "dataset.json").write_text(json.dumps({"labels": labels}))
    dest = str(tmp_path_factory.mktemp("zips") / "data.zip")
    ttool.convert_dataset(str(d), dest)
    return dest


@pytest.mark.parametrize("xflip,max_size", [(False, None), (True, 13)])
def test_native_matches_image_folder_and_jax(built, data_zip, xflip,
                                             max_size):
    kw = dict(use_labels=True, xflip=xflip, max_size=max_size,
              random_seed=3)
    nat = tnl.NativeZipDataset(data_zip, **kw)
    py = ImageFolderDataset(data_zip, **kw)
    assert len(nat) == len(py) and nat.image_shape == py.image_shape
    assert nat.label_dim == py.label_dim == 4 and nat.has_labels
    idxs = list(range(len(py)))
    imgs, labels = nat.read_batch(idxs)
    for k in idxs:
        img, label = py[k]
        np.testing.assert_array_equal(imgs[k], img)
        np.testing.assert_array_equal(labels[k], label)
    if jnl.build_native():
        jnat = jnl.NativeZipDataset(data_zip, **kw)
        jimgs, jlabels = jnat.read_batch(idxs)
        np.testing.assert_array_equal(imgs, jimgs)
        np.testing.assert_array_equal(labels, jlabels)
        jnat.close()
    nat.close()


def test_native_loader_order_matches_data_loader(built, data_zip):
    """The same batches in the same order as the threaded Python loader."""
    nat = tnl.NativeZipDataset(data_zip, xflip=True)
    py = ImageFolderDataset(data_zip, xflip=True)
    a = tnl.native_data_loader(nat, 6, seed=5)
    b = data_loader(py, 6, seed=5)
    for _ in range(4):
        (ia, la), (ib, lb) = next(a), next(b)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)
    a.close()
    b.close()


def test_native_decodes_every_filter_and_colour(built, tmp_path):
    """PNG rows of each filter type, gray and RGB, 16-bit samples, packed
    gray and palette images: the port's zlib decoder against JAX's libpng
    loader (16-bit samples keep their high byte, palettes become RGB) and,
    for 8-bit images, against the pixels written."""
    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    gray = rng.randint(0, 256, (9, 11)).astype(np.uint8)
    cases = {}
    for t in range(5):
        cases[f"rgb{t}.png"] = (encode_png(rgb, filter_type=t), rgb)
        cases[f"gray{t}.png"] = (encode_png(gray, filter_type=t),
                                 gray[..., None])
    for mode, arr in (("I;16", gray.astype(np.uint16) * 251),
                      ("1", gray > 127), ("P", gray)):
        buf = io.BytesIO()
        im = (PIL.Image.fromarray(arr).convert("P") if mode == "P"
              else PIL.Image.fromarray(arr, mode) if mode == "1"
              else PIL.Image.fromarray(arr))
        im.save(buf, format="png")
        cases[f"mode_{mode.replace(';', '')}.png"] = (buf.getvalue(), None)
    jax_lib = jnl.build_native()
    for name, (data, want) in cases.items():
        path = tmp_path / f"{name}.zip"
        with zipfile.ZipFile(path, "w") as z:
            z.writestr(name, data)
        ds = tnl.NativeZipDataset(str(path))
        img, _ = ds.read_batch([0])
        ds.close()
        if want is not None:
            np.testing.assert_array_equal(img[0], want.transpose(2, 0, 1),
                                          err_msg=name)
        if jax_lib:
            jds = jnl.NativeZipDataset(str(path))
            jimg, _ = jds.read_batch([0])
            jds.close()
            np.testing.assert_array_equal(img, jimg, err_msg=name)


def _interlaced(png: bytes) -> bytes:
    """The PNG with IHDR's interlace byte set (CRC recomputed)."""
    ihdr = bytearray(png[12:12 + 17])          # tag + 13-byte body
    ihdr[4 + 12] = 1
    crc = struct.pack(">I", zlib.crc32(bytes(ihdr)) & 0xFFFFFFFF)
    return png[:12] + bytes(ihdr) + crc + png[12 + 17 + 4:]


def test_native_refuses_interlaced_and_missing(built, tmp_path):
    path = tmp_path / "adam7.zip"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("a.png", _interlaced(encode_png(
            np.zeros((8, 8, 3), np.uint8))))
    with pytest.raises(IOError, match="interlaced"):
        tnl.NativeZipDataset(str(path))
    with pytest.raises(IOError):
        tnl.NativeZipDataset(str(tmp_path / "missing.zip"))
