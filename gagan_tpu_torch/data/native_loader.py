"""ctypes bindings for the port's native dataset-zip loader (port of
gagan_tpu/data/native_loader.py over ``csrc/gagan_loader.cpp``).

The zip's central directory is indexed once in C++, and each batch's PNG
decode and CHW / x-flip transform fan out over threads without the GIL.
The library is the port's own copy of ``native/gagan_loader.cpp``, which
decodes PNG on zlib alone (the card's machine has no libpng); ``_build.py``
compiles it with ``g++`` at first use into ``gagan_tpu_torch/build/``.  It
never writes into ``native/`` and never loads the library there.

``NativeZipDataset`` and ``native_data_loader`` keep the JAX module's API,
images, labels, x-flips and order, which are those of ``ImageFolderDataset``
and ``data_loader`` on the same zip.
"""

from __future__ import annotations

import ctypes
import json
import os
import queue as queue_lib
import threading
import zipfile
from typing import Optional, Tuple

import numpy as np

from ..utils.observability import trace_scope
from .dataset import IMAGE_EXTENSIONS, InfiniteSampler

_lib = None
_error: Optional[str] = None


def _get_lib():
    global _lib, _error
    if _lib is None:
        from .._build import load_host

        try:
            lib = load_host("gagan_loader")
        except (RuntimeError, OSError) as e:
            _error = str(e)
            raise RuntimeError(f"native loader unavailable: {e}") from e
        lib.gl_open.restype = ctypes.c_void_p
        lib.gl_open.argtypes = [ctypes.c_char_p]
        lib.gl_error.restype = ctypes.c_char_p
        lib.gl_error.argtypes = [ctypes.c_void_p]
        lib.gl_num_images.restype = ctypes.c_longlong
        lib.gl_num_images.argtypes = [ctypes.c_void_p]
        lib.gl_shape.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_int)] * 3
        lib.gl_read_batch.restype = ctypes.c_int
        lib.gl_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte)]
        lib.gl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _get_lib()
        return True
    except RuntimeError:
        return False


def build_error() -> Optional[str]:
    """Why the library did not build (the compiler's output), or None."""
    native_available()
    return _error


class NativeZipDataset:
    """ImageFolderDataset-compatible reader of a dataset zip backed by the
    C++ loader: the same max_size / xflip / label semantics, with batch
    reads decoded natively."""

    def __init__(self, path: str, max_size: Optional[int] = None,
                 use_labels: bool = False, xflip: bool = False,
                 random_seed: int = 0):
        lib = _get_lib()
        self._lib = lib
        self._handle = lib.gl_open(path.encode())
        err = lib.gl_error(self._handle)
        if err:
            lib.gl_close(self._handle)
            self._handle = None
            raise IOError(f"native loader: {err.decode()}")
        self._path = path
        n_raw = int(lib.gl_num_images(self._handle))
        c, h, w = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        lib.gl_shape(self._handle, ctypes.byref(c), ctypes.byref(h),
                     ctypes.byref(w))
        self._shape = (c.value, h.value, w.value)
        self.name = os.path.splitext(os.path.basename(path))[0]

        self._use_labels = use_labels
        self._raw_labels = None

        self._raw_idx = np.arange(n_raw, dtype=np.int64)
        if max_size is not None and self._raw_idx.size > max_size:
            np.random.RandomState(random_seed).shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])
        self._xflip = np.zeros(self._raw_idx.size, dtype=np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate([self._xflip,
                                          np.ones_like(self._xflip)])

    def _get_raw_labels(self):
        if self._raw_labels is None:
            labels = None
            if self._use_labels:
                with zipfile.ZipFile(self._path) as z:
                    if "dataset.json" in z.namelist():
                        with z.open("dataset.json") as f:
                            labels = json.load(f)["labels"]
            if labels:
                with zipfile.ZipFile(self._path) as z:
                    names = sorted(
                        n for n in z.namelist()
                        if os.path.splitext(n)[1].lower() in IMAGE_EXTENSIONS)
                lmap = dict(labels)
                arr = np.array([lmap[n] for n in names])
                self._raw_labels = arr.astype(
                    {1: np.int64, 2: np.float32}[arr.ndim])
            else:
                self._raw_labels = np.zeros(
                    [len(self._raw_idx), 0], dtype=np.float32)
        return self._raw_labels

    @property
    def image_shape(self):
        return list(self._shape)

    @property
    def num_channels(self):
        return self._shape[0]

    @property
    def resolution(self):
        return self._shape[1]

    @property
    def label_shape(self):
        raw = self._get_raw_labels()
        if raw.dtype == np.int64:
            return [int(np.max(raw)) + 1]
        return list(raw.shape[1:])

    @property
    def label_dim(self):
        return self.label_shape[0] if self.label_shape else 0

    @property
    def has_labels(self):
        return any(x != 0 for x in self.label_shape)

    def __len__(self):
        return self._raw_idx.size

    def get_label(self, idx):
        label = self._get_raw_labels()[self._raw_idx[idx]]
        if label.dtype == np.int64:
            onehot = np.zeros(self.label_shape, dtype=np.float32)
            onehot[label] = 1
            label = onehot
        return label.copy()

    def read_batch(self, idxs) -> Tuple[np.ndarray, np.ndarray]:
        """Decode a batch natively: (images [N, C, H, W] uint8, labels)."""
        idxs = np.asarray(idxs, dtype=np.int64)
        raw = np.ascontiguousarray(self._raw_idx[idxs])
        flips = np.ascontiguousarray(self._xflip[idxs])
        c, h, w = self._shape
        out = np.empty((len(idxs), c, h, w), dtype=np.uint8)
        rc = self._lib.gl_read_batch(
            self._handle,
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            flips.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            len(idxs),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if rc != 0:
            raise IOError("native batch decode failed")
        labels = np.stack([self.get_label(int(i)) for i in idxs])
        return out, labels

    def __getitem__(self, idx):
        imgs, labels = self.read_batch([idx])
        return imgs[0], labels[0]

    def close(self):
        if self._handle:
            self._lib.gl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_data_loader(dataset: NativeZipDataset, batch_size: int,
                       seed: int = 0, prefetch: int = 2, to_device=None,
                       rows=None):
    """Infinite batch iterator over the native dataset (the sampler of
    ``data.dataset.InfiniteSampler``) with a background prefetch thread;
    ``to_device`` and a rank's ``rows`` as in ``data.dataset.data_loader``.
    ``close()`` stops the thread."""
    sampler = iter(InfiniteSampler(len(dataset), seed=seed))
    out_q: queue_lib.Queue = queue_lib.Queue(maxsize=prefetch)
    stop = threading.Event()

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
                with trace_scope("loader.read_batch"):
                    idxs = [next(sampler) for _ in range(batch_size)]
                    if rows is not None:
                        idxs = [idxs[i] for i in rows]
                    batch = dataset.read_batch(idxs)
                    if to_device is not None:
                        batch = to_device(batch)
                put(batch)
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

    return _Iter()
