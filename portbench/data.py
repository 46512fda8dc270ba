"""Inputs made from the seed: a dataset zip of PNG images, written by the
benchmark's own PNG writer (zlib, filter 0), and the images themselves."""

from __future__ import annotations

import os
import struct
import zipfile
import zlib

import numpy as np


def images(seed: int, n: int, res: int, channels: int = 3) -> np.ndarray:
    """``n`` uint8 images [n, res, res, channels]: seeded colour blocks of
    res/16 pixels with seeded noise of +-8 levels on top, so that the
    images differ and their PNGs compress."""
    rng = np.random.default_rng(seed)
    block = max(res // 16, 1)
    coarse = rng.integers(0, 256, (n, res // block, res // block, channels),
                          dtype=np.int16)
    img = coarse.repeat(block, axis=1).repeat(block, axis=2)
    img = img + rng.integers(-8, 9, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def png_bytes(img: np.ndarray) -> bytes:
    """One [H, W, C] uint8 image (C 1 or 3) as a PNG, every row filter 0."""
    h, w, c = img.shape
    color = {1: 0, 3: 2}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_zip(path: str, imgs: np.ndarray) -> str:
    """The images as a dataset zip (``img00000000.png``, ... stored)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for i, img in enumerate(imgs):
            z.writestr(f"img{i:08d}.png", png_bytes(img))
    return path
