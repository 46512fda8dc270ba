"""Build and bind the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/`` beside this file,
named by a hash of the source so that an edited source is rebuilt.  The
libraries are loaded with ``ctypes``.  All sources are compiled in parallel,
one ``nvcc`` each.  Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "$CUDA_HOME/bin); the CUDA kernels cannot be built")


def _lib_path(src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(sources: Optional[list] = None) -> Dict[str, str]:
    """Compile every source whose library is missing, all at once; returns
    {source name: library path}.  nvcc's output (with ptxas' register and
    shared-memory report) is kept beside each library as ``<lib>.log``.
    Raises with that output on failure."""
    sources = sources or sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = {os.path.basename(s): _lib_path(s) for s in sources}
    procs = []
    for src in sources:
        lib = out[os.path.basename(src)]
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        with open(lib + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    with _lock:
        if name not in _libs:
            path = build_all([os.path.join(CSRC_DIR, name + ".cu")])[
                name + ".cu"]
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]
