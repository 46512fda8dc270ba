"""Pretrained-artifact fetcher (port of gagan_tpu/utils/download.py).

Maps short artifact names to their published URLs and unpacks archives
into ``GAGAN_PRETRAINED_DIR`` (default ``./pretrained``).  Downloaded
torch checkpoints become the packages' npz layout through
``python -m gagan_tpu_torch.cli.convert_weights``.  Without network access
set ``GAGAN_PRETRAINED_DIR`` to a directory that already holds the files;
``fetch`` then resolves them locally.  Standard library only.
"""

from __future__ import annotations

import os
import tarfile
import urllib.request
import zipfile
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class Source:
    url: str
    filename: str
    extract: bool = False  # zip/tar archives are unpacked in place


SOURCES: Dict[str, Source] = {
    "sg2-ffhq": Source(
        "https://nxt.2a2i.org/index.php/s/kyR9byFznz5GBTd/download/"
        "stylegan2-ffhq-config-f.pt.zip",
        "stylegan2-ffhq-config-f.pt.zip", extract=True),
    "e4e": Source(
        "https://nxt.2a2i.org/index.php/s/ey49AsRwgyK77C9/download/"
        "e4e_ffhq_encode.pt.zip", "e4e_ffhq_encode.pt.zip", extract=True),
    "clip_means": Source(
        "https://nxt.2a2i.org/index.php/s/CbxaqSy6C7sFNW2/download/"
        "clip_means.zip", "clip_means.zip", extract=True),
    "checkpoints": Source(
        "https://nxt.2a2i.org/index.php/s/eDWLK8rDzSFoxeZ/download/"
        "checkpoints.tar.gz", "checkpoints.tar.gz", extract=True),
    "sg2_tuned": Source(
        "https://nxt.2a2i.org/index.php/s/JzwG7gFHaKrHwDt/download/"
        "StyleGAN2_ADA.zip", "StyleGAN2_ADA.zip", extract=True),
    "sg2": Source(
        "https://nxt.2a2i.org/index.php/s/2K3jbFD3Tg7QmHA/download/"
        "StyleGAN2.zip", "StyleGAN2.zip", extract=True),
    "image_domains": Source(
        "https://nxt.2a2i.org/index.php/s/ZTBnffeW5TfrJjy/download/"
        "image_domains.zip", "image_domains.zip", extract=True),
}

_ARCHIVE_SUFFIXES = (".zip", ".tar.gz", ".tgz", ".tar")


def pretrained_dir() -> str:
    return os.environ.get("GAGAN_PRETRAINED_DIR", "pretrained")


def _unpack(path: str, dest_dir: str):
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            zf.extractall(dest_dir)
    else:
        with tarfile.open(path) as tf:
            tf.extractall(dest_dir, filter="data")


def fetch(name: str, dest_dir: Optional[str] = None,
          force: bool = False) -> str:
    """The local path of artifact ``name``, downloaded if absent (or if
    ``force``).  Raises KeyError for an unknown name and RuntimeError when
    the file is absent and the download fails."""
    if name not in SOURCES:
        raise KeyError(f"unknown artifact {name!r}; known: "
                       f"{sorted(SOURCES)}")
    src = SOURCES[name]
    dest_dir = dest_dir or pretrained_dir()
    os.makedirs(dest_dir, exist_ok=True)
    path = os.path.join(dest_dir, src.filename)
    marker = path + ".extracted"
    if not force and (os.path.exists(marker) or
                      (os.path.exists(path) and not src.extract)):
        return _final_path(path, src)

    if force or not os.path.exists(path):
        try:
            urllib.request.urlretrieve(src.url, path)
        except Exception as exc:  # no network, or the host is unreachable
            raise RuntimeError(
                f"cannot download {name!r} from {src.url}: {exc}. "
                f"Place {src.filename} under {dest_dir} manually (or set "
                f"GAGAN_PRETRAINED_DIR to a pre-populated directory)."
            ) from exc

    if src.extract:
        _unpack(path, dest_dir)
        with open(marker, "w") as fh:
            fh.write("ok")
    return _final_path(path, src)


def _final_path(path: str, src: Source) -> str:
    """An archive's unpacked directory named after it, where it has one
    (else the destination directory); a plain file's own path."""
    if not src.extract:
        return path
    stem = src.filename
    for suffix in _ARCHIVE_SUFFIXES:
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
            break
    candidate = os.path.join(os.path.dirname(path), stem)
    return candidate if os.path.exists(candidate) else os.path.dirname(path)
