"""PyTorch/CUDA port of gagan_tpu, for NVIDIA Hopper cards (sm_90a).

The package mirrors ``gagan_tpu`` module for module (same parameter keys,
config field names and NCHW / OIHW / ``ws [N, num_ws, w_dim]`` layouts), so a
snapshot written by either package loads in the other.  It imports torch and
numpy only: never JAX and nothing of ``gagan_tpu``.

Where the JAX package wrote a Pallas kernel, the port has a CUDA C++ kernel in
``csrc/`` (built by ``_build.py`` at first use); where JAX left the work to
XLA, the port uses stock torch ops.  Entry points run on CUDA unless the
caller asks for ``device="cpu"``; they never fall back to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on; raises when CUDA is asked
    for (the default) and no CUDA device is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gagan_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return device
