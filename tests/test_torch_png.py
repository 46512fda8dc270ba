"""The port's PNG reader and writer (gagan_tpu_torch.utils.png) against
Pillow: PNGs whose rows are filtered by hand with each of the five filter
types, PNGs that Pillow writes (its encoder picks the filters), and the
writer's output read back by Pillow.  PNG is lossless: pixels must be equal."""

import io
import struct
import zlib

import numpy as np
import PIL.Image
import pytest

from gagan_tpu_torch.utils import png

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(row, prev, bpp, ft):
    """The encoder side of PNG filter ``ft`` on one row (int arrays)."""
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    pred = {0: 0, 1: left, 2: prev, 3: (left + prev) // 2,
            4: _paeth(left, prev, upleft)}[ft]
    return ((row - pred) % 256).astype(np.uint8)


def _encode(img, filters):
    """A PNG of ``img`` [H, W, C] whose row y uses filter filters[y]."""
    h, w, c = img.shape
    prev = np.zeros(w * c, np.int64)
    lines = []
    for y in range(h):
        row = img[y].reshape(-1).astype(np.int64)
        ft = filters[y % len(filters)]
        lines.append(bytes([ft]) + _filter_row(row, prev, c, ft).tobytes())
        prev = row
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (png.SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                              0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(b"".join(lines)))
            + png._chunk(b"IEND", b""))


def _image(seed, h, w, c):
    """Smooth gradients plus noise: every predictor gets picked somewhere."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 7 + xx * 3)[:, :, None] + rng.randint(0, 40, (h, w, c))
    base[rng.rand(h, w) < 0.1] = 255
    return (base % 256).astype(np.uint8)


def _pil(data):
    return np.array(PIL.Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4, "mixed"])
def test_read_png_hand_filtered_matches_pillow(ft, channels):
    img = _image(ft if ft != "mixed" else 9, 13, 11, channels)
    filters = [0, 1, 2, 3, 4, 4, 3, 1] if ft == "mixed" else [ft]
    data = _encode(img, filters)
    got = png.read_png(data)
    want = _pil(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(img.shape), img)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_png_pillow_written(channels, tmp_path):
    img = _image(channels, 40, 33, channels)
    path = str(tmp_path / "p.png")
    PIL.Image.fromarray(img[:, :, 0] if channels == 1 else img,
                        MODES[channels]).save(path)
    want = np.array(PIL.Image.open(path))
    with open(path, "rb") as f:
        assert np.array_equal(png.read_png(f), want)
    np.testing.assert_array_equal(png.read_png(path), want)


def test_read_png_palette_indices(tmp_path):
    img = PIL.Image.fromarray(_image(5, 20, 24, 3)).quantize(100)
    path = str(tmp_path / "p.png")
    img.save(path)
    np.testing.assert_array_equal(png.read_png(path),
                                  np.array(PIL.Image.open(path)))


@pytest.mark.parametrize("shape", [(6, 5), (6, 5, 1), (6, 5, 2), (6, 5, 3),
                                   (6, 5, 4)])
def test_write_png_round_trips_through_pillow(shape, tmp_path):
    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    got = PIL.Image.open(path)
    assert got.mode == MODES[shape[2] if len(shape) == 3 else 1]
    np.testing.assert_array_equal(np.array(got).reshape(shape), img)
    np.testing.assert_array_equal(png.read_png(path).reshape(shape), img)


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
def test_write_png_filter_types_round_trip(ft, tmp_path):
    img = _image(ft + 20, 17, 9, 3)
    path = str(tmp_path / "f.png")
    png.write_png(path, img, filter_type=ft)
    with open(path, "rb") as f:
        data = f.read()
    assert zlib.decompress(data[8 + 25 + 8:-12 - 4])[0] == ft   # row 0
    np.testing.assert_array_equal(np.array(PIL.Image.open(path)), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_rejects_what_it_cannot_read(tmp_path):
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(b"GIF89a....")
    data = bytearray(_encode(_image(0, 8, 8, 3), [0]))
    data[8 + 8 + 12] = 1                  # IHDR's interlace byte: Adam7
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.read_png(bytes(data))
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.float32))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_many_average_and_paeth_rows_take_the_diagonal_sweep(channels,
                                                             monkeypatch):
    """An image whose rows mix all five filter types, most of them Average
    and Paeth, and Pillow's own adaptive encoding of a smooth image: the
    pixels written, as Pillow reads them, by the diagonal sweep (its
    threshold set to 0 at this small size) and by the row loop."""
    rng = np.random.RandomState(channels)
    h, w = 96, 80
    img = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
    types = rng.choice([0, 1, 2, 3, 4], size=h, p=[0.1, 0.1, 0.1, 0.3, 0.4])
    rows = np.stack([png._filter(img[y:y + 1] if y == 0 else img[y - 1:y + 1],
                                 int(t))[-1] for y, t in enumerate(types)])
    raw = np.concatenate([types.astype(np.uint8)[:, None], rows], axis=1)
    colour = {1: 0, 3: 2, 4: 6}[channels]
    data = (png.SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                              0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + png._chunk(b"IEND", b""))
    want = np.asarray(PIL.Image.open(io.BytesIO(data)))
    loop = png.read_png(data)
    monkeypatch.setattr(png, "_SWEEP_BYTES_PER_DIAGONAL", 0)
    got = png.read_png(data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(loop, want)
    np.testing.assert_array_equal(got.reshape(h, w, channels), img)
    smooth = np.asarray(PIL.Image.fromarray(img[:12, :12, :3] if channels > 1
                                            else img[:12, :12, 0])
                        .resize((256, 256), PIL.Image.BICUBIC))
    buf = io.BytesIO()
    PIL.Image.fromarray(smooth).save(buf, format="png", compress_level=0)
    np.testing.assert_array_equal(png.read_png(buf.getvalue()), smooth)
