"""Image datasets (zip / folder) with labels and xflip expansion, the
infinite shuffled sampler, and a threaded loader (port of
gagan_tpu/data/dataset.py).

The semantics are the JAX module's, item for item: uint8 CHW images, optional
``dataset.json`` labels (int64 -> one-hot float32), a ``max_size`` subset
shuffled by ``RandomState(random_seed)`` before the xflip doubling, and the
sampler's numpy stream, so both packages draw the same images in the same
order.  PNG files are decoded by the port's own reader (utils/png.py), which
needs no Pillow; other formats go through Pillow, imported only when such a
file is met.
"""

from __future__ import annotations

import io
import json
import os
import queue as queue_lib
import threading
import zipfile
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils.png import SIGNATURE as PNG_SIGNATURE, read_png

# Pillow's registered extensions (``PIL.Image.init(); PIL.Image.EXTENSION``),
# copied so that the port picks the same files as the JAX package without
# importing Pillow.
IMAGE_EXTENSIONS = frozenset((
    ".apng", ".avif", ".avifs", ".blp", ".bmp", ".bufr", ".bw", ".cur",
    ".dcx", ".dds", ".dib", ".emf", ".eps", ".fit", ".fits", ".flc", ".fli",
    ".ftc", ".ftu", ".gbr", ".gif", ".grib", ".h5", ".hdf", ".icb", ".icns",
    ".ico", ".iim", ".im", ".j2c", ".j2k", ".jfif", ".jp2", ".jpc", ".jpe",
    ".jpeg", ".jpf", ".jpg", ".jpx", ".mpeg", ".mpg", ".mpo", ".msp",
    ".palm", ".pbm", ".pcd", ".pcx", ".pdf", ".pfm", ".pgm", ".png", ".pnm",
    ".ppm", ".ps", ".psd", ".pxr", ".qoi", ".ras", ".rgb", ".rgba", ".sgi",
    ".tga", ".tif", ".tiff", ".vda", ".vst", ".webp", ".wmf", ".xbm",
    ".xpm"))


def decode_image(f, fname: str) -> np.ndarray:
    """An image file's pixels as ``np.array(PIL.Image.open(f))`` gives them:
    PNG by the port's reader, anything else by Pillow."""
    if os.path.splitext(fname)[1].lower() == ".png":
        return read_png(f)
    return np.array(_pil_image(fname).open(f))


def _pil_image(fname: str):
    """Pillow's Image module, or an ImportError naming the file."""
    try:
        import PIL.Image
    except ImportError as e:
        raise ImportError(
            f"{fname}: decoding this image needs Pillow, which is not "
            f"installed; the port reads PNG without it: convert the image "
            f"to an 8-bit PNG without a palette") from e
    return PIL.Image


def read_rgb(fname: str) -> np.ndarray:
    """[H, W, 3] uint8 pixels of an image file, as
    ``np.array(PIL.Image.open(fname).convert("RGB"))`` gives them: PNG by
    the port's reader (gray repeated, alpha dropped), a palette PNG or any
    other format by Pillow."""
    with open(fname, "rb") as f:
        return decode_rgb(f.read(), fname)


def decode_rgb(data: bytes, fname: str = "<bytes>") -> np.ndarray:
    """:func:`read_rgb` of an image file's bytes; ``fname`` names it in an
    error."""
    # Byte 25 is the PNG's colour type (3: palette).
    if data[:8] == PNG_SIGNATURE and len(data) > 25 and data[25] != 3:
        img = read_png(data)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[2] <= 2:
            img = np.repeat(img[..., :1], 3, axis=2)
        return np.ascontiguousarray(img[..., :3])
    return np.array(_pil_image(fname).open(io.BytesIO(data)).convert("RGB"))


class ImageFolderDataset:
    """Zip archive or directory of images, NVlabs dataset-zip compatible."""

    def __init__(
        self,
        path: str,
        resolution: Optional[int] = None,
        max_size: Optional[int] = None,
        use_labels: bool = False,
        xflip: bool = False,
        random_seed: int = 0,
    ):
        self._path = path
        self._zipfile = None
        self._use_labels = use_labels
        self._raw_labels = None

        if os.path.isdir(path):
            self._type = "dir"
            self._all_fnames = {
                os.path.relpath(os.path.join(root, fname), start=path)
                for root, _dirs, files in os.walk(path) for fname in files
            }
        elif self._file_ext(path) == ".zip":
            self._type = "zip"
            self._all_fnames = set(self._get_zipfile().namelist())
        else:
            raise IOError("Path must be a directory or zip archive")

        self._image_fnames = sorted(
            f for f in self._all_fnames
            if self._file_ext(f) in IMAGE_EXTENSIONS)
        if len(self._image_fnames) == 0:
            raise IOError("No image files found in the specified path")

        name = os.path.splitext(os.path.basename(path))[0]
        raw_shape = [len(self._image_fnames)] + list(
            self._load_raw_image(0).shape)
        if resolution is not None and (
            raw_shape[2] != resolution or raw_shape[3] != resolution
        ):
            raise IOError("Image files do not match the specified resolution")
        self._name = name
        self._raw_shape = raw_shape

        # max_size subset, then xflip doubling.
        self._raw_idx = np.arange(self._raw_shape[0], dtype=np.int64)
        if max_size is not None and self._raw_idx.size > max_size:
            np.random.RandomState(random_seed).shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])
        self._xflip = np.zeros(self._raw_idx.size, dtype=np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate([self._xflip,
                                          np.ones_like(self._xflip)])

    @staticmethod
    def _file_ext(fname: str) -> str:
        return os.path.splitext(fname)[1].lower()

    def _get_zipfile(self) -> zipfile.ZipFile:
        assert self._type == "zip"
        if self._zipfile is None:
            self._zipfile = zipfile.ZipFile(self._path)
        return self._zipfile

    def _open_file(self, fname):
        if self._type == "dir":
            return open(os.path.join(self._path, fname), "rb")
        return self._get_zipfile().open(fname, "r")

    def close(self):
        if self._zipfile is not None:
            self._zipfile.close()
            self._zipfile = None

    def _load_raw_image(self, raw_idx: int) -> np.ndarray:
        fname = self._image_fnames[raw_idx]
        with self._open_file(fname) as f:
            image = decode_image(f, fname)
        if image.ndim == 2:
            image = image[:, :, np.newaxis]  # HW -> HWC
        return image.transpose(2, 0, 1)      # HWC -> CHW

    def _load_raw_labels(self):
        fname = "dataset.json"
        if fname not in self._all_fnames:
            return None
        with self._open_file(fname) as f:
            labels = json.load(f)["labels"]
        if labels is None:
            return None
        labels = dict(labels)
        labels = [labels[fname.replace("\\", "/")]
                  for fname in self._image_fnames]
        labels = np.array(labels)
        labels = labels.astype({1: np.int64, 2: np.float32}[labels.ndim])
        return labels

    def _get_raw_labels(self) -> np.ndarray:
        if self._raw_labels is None:
            self._raw_labels = (self._load_raw_labels()
                                if self._use_labels else None)
            if self._raw_labels is None:
                self._raw_labels = np.zeros([self._raw_shape[0], 0],
                                            dtype=np.float32)
        return self._raw_labels

    def __len__(self) -> int:
        return self._raw_idx.size

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        image = self._load_raw_image(self._raw_idx[idx])
        assert image.dtype == np.uint8
        if self._xflip[idx]:
            image = image[:, :, ::-1]
        return image.copy(), self.get_label(idx)

    def get_label(self, idx: int) -> np.ndarray:
        label = self._get_raw_labels()[self._raw_idx[idx]]
        if label.dtype == np.int64:
            onehot = np.zeros(self.label_shape, dtype=np.float32)
            onehot[label] = 1
            label = onehot
        return label.copy()

    @property
    def name(self) -> str:
        return self._name

    @property
    def image_shape(self) -> List[int]:
        return list(self._raw_shape[1:])

    @property
    def num_channels(self) -> int:
        return self.image_shape[0]

    @property
    def resolution(self) -> int:
        assert self.image_shape[1] == self.image_shape[2]
        return self.image_shape[1]

    @property
    def label_shape(self) -> List[int]:
        raw_labels = self._get_raw_labels()
        if raw_labels.dtype == np.int64:
            return [int(np.max(raw_labels)) + 1]
        return list(raw_labels.shape[1:])

    @property
    def label_dim(self) -> int:
        assert len(self.label_shape) == 1
        return self.label_shape[0]

    @property
    def has_labels(self) -> bool:
        return any(x != 0 for x in self.label_shape)


class InfiniteSampler:
    """Infinite shuffled index stream with windowed reshuffling,
    rank-interleaved for data-parallel replicas."""

    def __init__(self, dataset_size: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 window_size: float = 0.5):
        assert dataset_size > 0
        assert 0 <= rank < num_replicas
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))

        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
                if window >= 2:
                    j = (i - rnd.randint(window)) % order.size
                    order[i], order[j] = order[j], order[i]
            idx += 1


def data_loader(
    dataset: ImageFolderDataset,
    batch_size: int,
    seed: int = 0,
    num_workers: int = 4,
    prefetch: int = 2,
    to_device=None,
    rows=None,
):
    """Infinite batch iterator: threaded decode + bounded prefetch queue.

    Yields (images_uint8 [N,C,H,W], labels [N,label_dim]) numpy arrays, or
    whatever ``to_device`` makes of that pair (e.g. pinned tensors copied to
    the card).  ``close()`` stops the producer thread and the decode pool.

    ``rows``: a data-parallel rank's positions in each global batch of
    ``batch_size`` (``parallel.mesh.share_rows``); only they are decoded.
    Every rank samples the one-process index stream (the sampler's
    ``num_replicas`` would interleave ranks and reshuffle its window for
    the indices it yields only, drifting from that stream)."""
    from concurrent.futures import ThreadPoolExecutor

    sampler = iter(InfiniteSampler(len(dataset), seed=seed))
    pool = ThreadPoolExecutor(max_workers=num_workers)
    out_q: queue_lib.Queue = queue_lib.Queue(maxsize=prefetch)
    stop = threading.Event()

    def make_batch():
        idxs = [next(sampler) for _ in range(batch_size)]
        if rows is not None:
            idxs = [idxs[i] for i in rows]
        items = list(pool.map(dataset.__getitem__, idxs))
        images = np.stack([im for im, _ in items])
        labels = np.stack([lb for _, lb in items])
        return images, labels

    def put(item):
        while not stop.is_set():
            try:
                out_q.put(item, timeout=1.0)
                return
            except queue_lib.Full:
                continue

    def producer():
        try:
            while not stop.is_set():
                batch = make_batch()
                put(to_device(batch) if to_device is not None else batch)
        except Exception as e:               # hand the failure to the reader
            put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            item = out_q.get()
            if isinstance(item, Exception):
                raise item
            return item

        def close(self):
            stop.set()
            thread.join()
            pool.shutdown(wait=True)

    return _Iter()
