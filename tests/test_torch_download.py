"""The port's artifact fetcher (``utils/download.py``) against a localhost
HTTP server, as ``tests/test_download.py`` holds the JAX one: download,
unpack, marker, cached return, forced re-download, the actionable error.
Nothing is fetched from an outside host."""

import dataclasses
import http.server
import io
import os
import tarfile
import threading
import zipfile

import pytest

from gagan_tpu.utils import download as jdl
from gagan_tpu_torch.utils import download as dl


@pytest.fixture()
def http_root(tmp_path):
    root = tmp_path / "served"
    root.mkdir()
    handler = lambda *a, **kw: http.server.SimpleHTTPRequestHandler(  # noqa: E731
        *a, directory=str(root), **kw)
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield root, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        thread.join(timeout=5)


def _zip_bytes(inner_name: str, payload: bytes) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr(inner_name, payload)
    return buf.getvalue()


def _tgz_bytes(inner_name: str, payload: bytes) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        info = tarfile.TarInfo(inner_name)
        info.size = len(payload)
        tf.addfile(info, io.BytesIO(payload))
    return buf.getvalue()


def test_sources_are_the_jax_packages():
    assert {k: dataclasses.astuple(v) for k, v in dl.SOURCES.items()} == {
        k: dataclasses.astuple(v) for k, v in jdl.SOURCES.items()}
    assert dl.pretrained_dir() == jdl.pretrained_dir()


def test_fetch_download_extract_and_cache(http_root, tmp_path, monkeypatch):
    root, base_url = http_root
    (root / "toy.pt.zip").write_bytes(
        _zip_bytes("toy.pt/weights.bin", b"\x01\x02\x03"))
    (root / "flat.bin").write_bytes(b"raw-artifact")
    (root / "ckpts.tar.gz").write_bytes(_tgz_bytes("ckpts/a.npz", b"npz"))
    monkeypatch.setitem(dl.SOURCES, "toy", dl.Source(
        f"{base_url}/toy.pt.zip", "toy.pt.zip", extract=True))
    monkeypatch.setitem(dl.SOURCES, "flat", dl.Source(
        f"{base_url}/flat.bin", "flat.bin", extract=False))
    monkeypatch.setitem(dl.SOURCES, "tgz", dl.Source(
        f"{base_url}/ckpts.tar.gz", "ckpts.tar.gz", extract=True))

    dest = tmp_path / "pretrained"
    out = dl.fetch("toy", dest_dir=str(dest))
    assert out == str(dest / "toy.pt")
    assert (dest / "toy.pt" / "weights.bin").read_bytes() == b"\x01\x02\x03"
    assert os.path.exists(str(dest / "toy.pt.zip.extracted"))

    # Cached: without force the old extract wins; force re-downloads.
    (root / "toy.pt.zip").write_bytes(_zip_bytes("toy.pt/weights.bin", b"\xff"))
    assert dl.fetch("toy", dest_dir=str(dest)) == out
    assert (dest / "toy.pt" / "weights.bin").read_bytes() == b"\x01\x02\x03"
    dl.fetch("toy", dest_dir=str(dest), force=True)
    assert (dest / "toy.pt" / "weights.bin").read_bytes() == b"\xff"

    flat = dl.fetch("flat", dest_dir=str(dest))
    assert flat == str(dest / "flat.bin")
    assert open(flat, "rb").read() == b"raw-artifact"

    # A tarball unpacks the same way.
    assert dl.fetch("tgz", dest_dir=str(dest)) == str(dest / "ckpts")
    assert (dest / "ckpts" / "a.npz").read_bytes() == b"npz"


def test_fetch_env_dir_unknown_and_unreachable(tmp_path, monkeypatch):
    with pytest.raises(KeyError):
        dl.fetch("no-such-artifact")
    monkeypatch.setitem(dl.SOURCES, "dead", dl.Source(
        "http://127.0.0.1:9/dead.bin", "dead.bin"))
    with pytest.raises(RuntimeError, match="Place dead.bin under"):
        dl.fetch("dead", dest_dir=str(tmp_path))
    # A pre-populated GAGAN_PRETRAINED_DIR resolves without a download.
    monkeypatch.setenv("GAGAN_PRETRAINED_DIR", str(tmp_path / "pre"))
    (tmp_path / "pre").mkdir()
    (tmp_path / "pre" / "dead.bin").write_bytes(b"here")
    assert dl.fetch("dead") == str(tmp_path / "pre" / "dead.bin")
