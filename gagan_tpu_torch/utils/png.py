"""A small PNG reader and writer on zlib and numpy.

The machine that runs the port on the card has neither Pillow nor any other
image library, so the port reads and writes PNG itself: 8-bit, non-interlaced
gray (``L``), gray + alpha, RGB, RGBA and palette indices.  PNG is lossless,
so :func:`read_png` gives the same pixels as ``np.array(PIL.Image.open(f))``
(for a palette image, the indices, as Pillow's mode ``P`` does).

Unfiltering: Sub is a cumulative sum mod 256 along the row and Up a row-wise
add, both in numpy; Average and Paeth depend on the reconstructed left
neighbour, so a few such rows run as a loop over the row's bytes, and an
image with many of them is swept one anti-diagonal of pixels at a time
(each pixel needs only its left, upper and upper-left neighbours).
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> samples per pixel (bit depth 8 only).
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def _filter(img: np.ndarray, filter_type: int) -> np.ndarray:
    """Every row of ``img`` [H, W, C] filtered with one PNG filter type
    (the encoder side: the predictors read the unfiltered pixels)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    zero_col = np.zeros((h, c), np.int16)
    left = np.concatenate([zero_col, x[:, :-c]], axis=1)
    up = np.concatenate([np.zeros((1, w * c), np.int16), x[:-1]], axis=0)
    upleft = np.concatenate([zero_col, up[:, :-c]], axis=1)
    if filter_type == 0:
        pred = 0
    elif filter_type == 1:
        pred = left
    elif filter_type == 2:
        pred = up
    elif filter_type == 3:
        pred = (left + up) // 2
    elif filter_type == 4:
        pa, pb = np.abs(up - upleft), np.abs(left - upleft)
        pc = np.abs(left + up - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"PNG filter type {filter_type} is not 0-4")
    return ((x - pred) % 256).astype(np.uint8)


def _adaptive_rows(img: np.ndarray) -> np.ndarray:
    """Each row filtered with the type whose bytes, read as signed, sum
    to the least absolute total (the first such type on a tie): the
    heuristic of libpng and of Pillow's PNG encoder."""
    h = img.shape[0]
    filtered = np.stack([_filter(img, t) for t in range(5)])   # [5, H, W*C]
    cost = np.abs(filtered.view(np.int8).astype(np.int64)).sum(axis=2)
    best = np.argmin(cost, axis=0)                              # [H]
    rows = filtered[best, np.arange(h)]
    return np.concatenate([best.astype(np.uint8)[:, None], rows], axis=1)


def encode_png(img: np.ndarray, level: int = 6, filter_type=0) -> bytes:
    """An 8-bit PNG of a uint8 image: [H, W] or [H, W, 1] as gray (``L``),
    [H, W, 3] as RGB, [H, W, 2] / [H, W, 4] as gray / RGB with alpha.
    ``filter_type``: one type for every row (0: none, 1: Sub, 2: Up, 3:
    Average, 4: Paeth), or "adaptive" for a choice per row as Pillow
    makes it."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in _COLOUR_TYPE):
        raise ValueError(f"expected [H, W] or [H, W, 1|2|3|4] uint8, got "
                         f"{img.dtype} {img.shape}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if filter_type == "adaptive":
        rows = _adaptive_rows(img)
    else:
        rows = np.concatenate([np.full((h, 1), filter_type, np.uint8),
                               _filter(img, filter_type)], axis=1)
    return b"".join([
        SIGNATURE,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c],
                                    0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)),
        _chunk(b"IEND", b"")])


def write_png(path: str, img: np.ndarray, level: int = 6,
              filter_type=0) -> None:
    """Write :func:`encode_png` of ``img`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img, level, filter_type))


def _unfilter_average(row: np.ndarray, prev: np.ndarray, bpp: int) -> None:
    out = row.tolist()
    up = prev.tolist()
    for i in range(bpp):
        out[i] = (out[i] + (up[i] >> 1)) & 0xFF
    for i in range(bpp, len(out)):
        out[i] = (out[i] + ((out[i - bpp] + up[i]) >> 1)) & 0xFF
    row[:] = out


def _unfilter_paeth(row: np.ndarray, prev: np.ndarray, bpp: int) -> None:
    out = row.tolist()
    up = prev.tolist()
    for i in range(bpp):                  # a = c = 0: the predictor is b
        out[i] = (out[i] + up[i]) & 0xFF
    for i in range(bpp, len(out)):
        a, b, c = out[i - bpp], up[i], up[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (out[i] + pred) & 0xFF
    row[:] = out


# Sweep diagonals when the Average / Paeth bytes exceed this many a
# diagonal (the two routes' costs, measured on a 1024^2 RGB image).
_SWEEP_BYTES_PER_DIAGONAL = 300


def _unfilter_wavefront(filt: np.ndarray, types: np.ndarray, w: int,
                        bpp: int) -> np.ndarray:
    """Every row at once, one anti-diagonal of pixels at a time: a pixel
    depends on its left, upper and upper-left neighbours only, which lie on
    the two diagonals before it, so each diagonal is one vectorised step
    whatever the rows' filter types."""
    h = filt.shape[0]
    f = filt.reshape(h, w, bpp).astype(np.int16)
    dec = np.zeros((h + 1, w + 1, bpp), np.int16)     # row 0, column 0: zeros
    ft = types.astype(np.int16)
    for d in range(w + h - 1):
        rs = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        xs = d - rs
        a = dec[rs + 1, xs]
        b = dec[rs, xs + 1]
        c = dec[rs, xs]
        t = ft[rs][:, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(t == 4, paeth, np.where(
            t == 3, (a + b) >> 1, np.where(t == 2, b, np.where(t == 1, a, 0))))
        dec[rs + 1, xs + 1] = (f[rs, xs] + pred) & 0xFF
    return dec[1:, 1:].astype(np.uint8).reshape(h, w * bpp)


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    lines = raw.reshape(h, stride + 1)
    types = lines[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(types.max())}")
    # Average and Paeth rows cost a Python loop over their bytes (~0.3 us a
    # byte); with many of them the diagonal sweep (~0.1 ms a diagonal) wins.
    if int((types >= 3).sum()) * stride > _SWEEP_BYTES_PER_DIAGONAL * (w + h):
        return _unfilter_wavefront(lines[:, 1:], types, w, bpp)
    out = lines[:, 1:].copy()
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        row = out[y]
        ft = types[y]
        if ft == 1:
            row[:] = np.cumsum(row.reshape(w, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif ft == 2:
            row += prev
        elif ft == 3:
            _unfilter_average(row, prev, bpp)
        elif ft == 4:
            _unfilter_paeth(row, prev, bpp)
        prev = row
    return out


def read_png(src: Union[str, bytes, BinaryIO]) -> np.ndarray:
    """Decode a PNG (a path, its bytes or an open binary file) to a uint8
    array shaped as ``np.array(PIL.Image.open(src))``: [H, W] for gray and
    palette indices, [H, W, C] otherwise."""
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    elif isinstance(src, str):
        with open(src, "rb") as f:
            data = f.read()
    else:
        data = src.read()
    name = src if isinstance(src, str) else getattr(src, "name", "<bytes>")
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{name}: unsupported PNG (bit depth {depth}, colour type "
            f"{colour}, interlace {interlace}); read_png takes 8-bit "
            f"non-interlaced gray, gray+alpha, RGB, RGBA and palette images")
    c = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError(f"{name}: {raw.size} bytes of scanlines for a "
                         f"{w}x{h}x{c} image")
    img = _unfilter(raw, h, w, c).reshape(h, w, c)
    return img[:, :, 0] if c == 1 else img
