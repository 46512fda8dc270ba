"""Dataset preprocessing (port of gagan_tpu/data/dataset_tool.py): convert an
image collection into the uniform dataset zip (PNGs + ``dataset.json``
labels).

    python -m gagan_tpu_torch.data.dataset_tool --source DIR|ZIP|LMDB|... \\
        --dest out.zip [--max-images N] [--transform center-crop] \\
        [--width 1024 --height 1024] [--resize-filter lanczos|box]

Sources: an image folder, a zip, an LSUN-style LMDB (read by the port's
``lmdb_reader``, no ``lmdb`` package), MNIST's idx-ubyte gz pair and the
CIFAR-10 python tarball.  Transforms: scale, center-crop and
center-crop-wide, resized as Pillow resizes (``ops/resize.py``: LANCZOS or
BOX, Pillow's pixels exactly).  The JAX tool's Pillow calls are replaced:
PNG is read by ``utils/png.py`` and written by ``encode_png`` with Pillow's
per-row filter choice; another image format needs Pillow and, without it
(as on the card's machine), raises naming the fix.  The command line is
argparse with the JAX click command's options and defaults.
"""

from __future__ import annotations

import argparse
import functools
import gzip
import json
import os
import pickle
import tarfile
import zipfile
from typing import Callable, Optional

import numpy as np

from ..ops.resize import resize_uint8
from ..utils.png import encode_png
from .dataset import IMAGE_EXTENSIONS, decode_rgb, read_rgb


class DatasetToolError(SystemExit):
    """A refusal of the tool, with its message (the JAX tool's
    ``click.ClickException``)."""


def error(msg):
    raise DatasetToolError(msg)


def maybe_min(a: int, b: Optional[int]) -> int:
    return min(a, b) if b is not None else a


def _is_image(fname: str) -> bool:
    return os.path.splitext(fname)[1].lower() in IMAGE_EXTENSIONS


def open_image_folder(source_dir, *, max_images: Optional[int]):
    input_images = sorted(
        os.path.join(root, fname)
        for root, _dirs, files in os.walk(source_dir)
        for fname in sorted(files) if _is_image(fname))

    labels = {}
    meta_fname = os.path.join(source_dir, "dataset.json")
    if os.path.isfile(meta_fname):
        with open(meta_fname, "r") as f:
            labels = json.load(f)["labels"]
            labels = dict(labels) if labels is not None else {}

    max_idx = maybe_min(len(input_images), max_images)

    def iterate_images():
        for idx, fname in enumerate(input_images):
            arch_fname = os.path.relpath(fname, source_dir).replace("\\", "/")
            yield dict(img=read_rgb(fname), label=labels.get(arch_fname))
            if idx >= max_idx - 1:
                break

    return max_idx, iterate_images()


def open_image_zip(source, *, max_images: Optional[int]):
    with zipfile.ZipFile(source) as z:
        input_images = [f for f in sorted(z.namelist()) if _is_image(f)]
        labels = {}
        if "dataset.json" in z.namelist():
            with z.open("dataset.json", "r") as f:
                labels = json.load(f)["labels"]
                labels = dict(labels) if labels is not None else {}

    max_idx = maybe_min(len(input_images), max_images)

    def iterate_images():
        with zipfile.ZipFile(source) as z:
            for idx, fname in enumerate(input_images):
                img = decode_rgb(z.read(fname), f"{source}:{fname}")
                yield dict(img=img, label=labels.get(fname))
                if idx >= max_idx - 1:
                    break

    return max_idx, iterate_images()


def open_lmdb(lmdb_dir: str, *, max_images: Optional[int]):
    """An LSUN-style LMDB of encoded images; an entry that does not decode
    is printed and skipped, as the JAX tool does.  A missing Pillow is not
    such an entry: it raises."""
    from .lmdb_reader import LMDBReader

    reader = LMDBReader(lmdb_dir)
    max_idx = maybe_min(len(reader), max_images)

    def iterate_images():
        for idx, (key, value) in enumerate(reader):
            try:
                img = decode_rgb(bytes(value), f"{lmdb_dir}:{key!r}")
            except ImportError:
                raise
            except Exception as e:
                print(e)
                continue
            yield dict(img=img, label=None)
            if idx >= max_idx - 1:
                break

    return max_idx, iterate_images()


def open_mnist(images_gz: str, *, max_images: Optional[int]):
    """MNIST's idx-ubyte pair, padded 28 -> 32."""
    labels_gz = images_gz.replace("-images-idx3-ubyte.gz",
                                  "-labels-idx1-ubyte.gz")
    assert labels_gz != images_gz
    with gzip.open(images_gz, "rb") as f:
        images = np.frombuffer(f.read(), np.uint8, offset=16)
    with gzip.open(labels_gz, "rb") as f:
        labels = np.frombuffer(f.read(), np.uint8, offset=8)
    images = images.reshape(-1, 28, 28)
    images = np.pad(images, [(0, 0), (2, 2), (2, 2)], "constant",
                    constant_values=0)
    assert images.shape[0] == labels.shape[0]
    max_idx = maybe_min(len(images), max_images)

    def iterate_images():
        for idx, img in enumerate(images):
            yield dict(img=img, label=int(labels[idx]))
            if idx >= max_idx - 1:
                break

    return max_idx, iterate_images()


def open_cifar10(tarball: str, *, max_images: Optional[int]):
    images = []
    labels = []
    with tarfile.open(tarball, "r:gz") as tar:
        for batch in range(1, 6):
            member = tar.getmember(f"cifar-10-batches-py/data_batch_{batch}")
            with tar.extractfile(member) as f:
                data = pickle.load(f, encoding="latin1")
            images.append(data["data"].reshape(-1, 3, 32, 32))
            labels.append(data["labels"])
    images = np.concatenate(images).transpose(0, 2, 3, 1)  # NHWC
    labels = np.concatenate([np.asarray(lb) for lb in labels])
    max_idx = maybe_min(len(images), max_images)

    def iterate_images():
        for idx, img in enumerate(images):
            yield dict(img=img, label=int(labels[idx]))
            if idx >= max_idx - 1:
                break

    return max_idx, iterate_images()


def open_dataset(source, *, max_images: Optional[int]):
    if os.path.isdir(source):
        if os.path.isfile(os.path.join(source, "data.mdb")):
            return open_lmdb(source, max_images=max_images)
        return open_image_folder(source, max_images=max_images)
    if os.path.isfile(source):
        if os.path.basename(source) == "cifar-10-python.tar.gz":
            return open_cifar10(source, max_images=max_images)
        if source.endswith("-images-idx3-ubyte.gz"):
            return open_mnist(source, max_images=max_images)
        if os.path.splitext(source)[1].lower() in (".mdb", ".lmdb"):
            return open_lmdb(source, max_images=max_images)
        if os.path.splitext(source)[1].lower() == ".zip":
            return open_image_zip(source, max_images=max_images)
    error(f"Missing or unsupported input: {source}")


def _resize(img: np.ndarray, width: int, height: int,
            resize_filter: str) -> np.ndarray:
    """Pillow's ``resize((width, height), filter)`` of a uint8 [H, W] or
    [H, W, C] array."""
    method = {"box": "box", "lanczos": "lanczos3"}[resize_filter]
    if img.ndim == 2:
        return resize_uint8(img[:, :, None], (height, width), method)[:, :, 0]
    return resize_uint8(img, (height, width), method)


def make_transform(
    transform: Optional[str],
    output_width: Optional[int],
    output_height: Optional[int],
    resize_filter: str = "lanczos",
) -> Callable[[np.ndarray], Optional[np.ndarray]]:
    """Scale / center-crop / center-crop-wide."""
    if resize_filter not in ("box", "lanczos"):
        error(f"Unknown resize filter: {resize_filter}")

    def scale(width, height, img):
        w, h = img.shape[1], img.shape[0]
        if width == w and height == h:
            return img
        ww = width if width is not None else w
        hh = height if height is not None else h
        return _resize(img, ww, hh, resize_filter)

    def center_crop(width, height, img):
        crop = np.min(img.shape[:2])
        img = img[(img.shape[0] - crop) // 2: (img.shape[0] + crop) // 2,
                  (img.shape[1] - crop) // 2: (img.shape[1] + crop) // 2]
        return _resize(img, width, height, resize_filter)

    def center_crop_wide(width, height, img):
        ch = int(np.round(width * img.shape[0] / img.shape[1]))
        if img.shape[1] < width or ch < height:
            return None
        img = img[(img.shape[0] - ch) // 2: (img.shape[0] + ch) // 2]
        img = _resize(img, width, height, resize_filter)
        canvas = np.zeros([width, width, 3], dtype=np.uint8)
        canvas[(width - height) // 2: (width + height) // 2, :] = img
        return canvas

    if transform is None:
        return functools.partial(scale, output_width, output_height)
    if transform == "center-crop":
        assert output_width and output_height
        return functools.partial(center_crop, output_width, output_height)
    if transform == "center-crop-wide":
        assert output_width and output_height
        return functools.partial(center_crop_wide, output_width, output_height)
    error(f"Unknown transform: {transform}")


def open_dest(dest: str):
    ext = os.path.splitext(dest)[1].lower()
    if ext == ".zip":
        if os.path.dirname(dest):
            os.makedirs(os.path.dirname(dest), exist_ok=True)
        zf = zipfile.ZipFile(dest, mode="w", compression=zipfile.ZIP_STORED)

        def save_bytes(fname, data):
            zf.writestr(fname, data)

        return "", save_bytes, zf.close

    os.makedirs(dest, exist_ok=True)

    def save_bytes(fname, data):
        path = os.path.join(dest, fname)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)

    return dest, save_bytes, lambda: None


def convert_dataset(
    source: str,
    dest: str,
    max_images: Optional[int] = None,
    transform: Optional[str] = None,
    resize_filter: str = "lanczos",
    width: Optional[int] = None,
    height: Optional[int] = None,
) -> None:
    """Convert ``source`` to the uniform dataset zip (or folder) ``dest``:
    PNGs at ``{idx:08d}[:5]/img{idx:08d}.png`` (zlib level 0, Pillow's
    per-row filters) and ``dataset.json``."""
    num_files, input_iter = open_dataset(source, max_images=max_images)
    _root, save_bytes, close_dest = open_dest(dest)
    transform_image = make_transform(transform, width, height, resize_filter)

    dataset_attrs = None
    labels = []
    for idx, image in enumerate(input_iter):
        idx_str = f"{idx:08d}"
        archive_fname = f"{idx_str[:5]}/img{idx_str}.png"

        img = transform_image(image["img"])
        if img is None:
            continue

        channels = img.shape[2] if img.ndim == 3 else 1
        cur_attrs = {"width": img.shape[1], "height": img.shape[0],
                     "channels": channels}
        if dataset_attrs is None:
            dataset_attrs = cur_attrs
            w, h = dataset_attrs["width"], dataset_attrs["height"]
            if w != h:
                error(f"Images must be square; got {w}x{h}")
            if w & (w - 1) != 0:
                error(f"Image width/height must be a power of two; got {w}")
        elif cur_attrs != dataset_attrs:
            error("Images do not all have the same dimensions/channels")

        if channels not in (1, 3):
            error(f"Images must have 1 or 3 channels; got {channels}")
        save_bytes(archive_fname, encode_png(img, level=0,
                                             filter_type="adaptive"))
        labels.append([archive_fname, image["label"]]
                      if image["label"] is not None else None)

    metadata = {
        "labels": labels if all(x is not None for x in labels) else None
    }
    save_bytes("dataset.json", json.dumps(metadata))
    close_dest()


def main(argv=None):
    """Convert an image dataset into the uniform dataset-zip format."""
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--source", required=True, metavar="PATH")
    parser.add_argument("--dest", required=True, metavar="PATH")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--resize-filter", choices=["box", "lanczos"],
                        default="lanczos")
    parser.add_argument("--transform",
                        choices=["center-crop", "center-crop-wide"])
    parser.add_argument("--width", type=int)
    parser.add_argument("--height", type=int)
    args = parser.parse_args(argv)
    convert_dataset(args.source, args.dest, max_images=args.max_images,
                    transform=args.transform,
                    resize_filter=args.resize_filter, width=args.width,
                    height=args.height)


if __name__ == "__main__":
    main()
