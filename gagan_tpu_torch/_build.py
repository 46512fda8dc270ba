"""Build and bind the package's CUDA kernels (``csrc/*.cu``) and its host
library (``csrc/gagan_loader.cpp``, the dataset-zip loader).

Each source is compiled at first use (``nvcc`` for ``sm_90a``; ``g++`` for
the host library) into a shared library with a plain C interface, under
``build/`` beside this file, named by a hash of the source and flags so that
an edited source is rebuilt.  The libraries are loaded with ``ctypes``.  All
CUDA sources are compiled in parallel, one ``nvcc`` each.  Nothing is built
when the package is imported.
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


def _lib_path(src: str, flags=NVCC_FLAGS) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(flags).encode())
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


HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
HOST_LIBS = ["-lz", "-pthread"]


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library built from ``csrc/<name>.cpp`` with ``g++``
    (built if needed).  Raises with the compiler's output when it does not
    build (e.g. no ``zlib.h``)."""
    with _lock:
        if name not in _libs:
            src = os.path.join(CSRC_DIR, name + ".cpp")
            lib = _lib_path(src, HOST_FLAGS + HOST_LIBS)
            if not os.path.exists(lib):
                cxx = shutil.which(os.environ.get("CXX", "g++"))
                if cxx is None:
                    raise RuntimeError(f"{name}: no C++ compiler (g++) on "
                                       f"PATH to build {src}")
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{lib}.{os.getpid()}.tmp"
                proc = subprocess.run(
                    [cxx, *HOST_FLAGS, src, "-o", tmp, *HOST_LIBS],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed to build {src} (it needs "
                                       f"zlib.h and -lz):\n{proc.stderr}")
                os.replace(tmp, lib)
            _libs[name] = ctypes.CDLL(lib)
        return _libs[name]
