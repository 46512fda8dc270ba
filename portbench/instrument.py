"""What the benchmark records around the program's calls, from its own
files: the shapes of the fused level's calls (for its roofline), and the
train step's first batches (for the comparison with the reference).
Each wrapper is put in place for one run and taken out after it."""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List

import torch


class LevelCalls:
    """Records each call of ``ops.fused_modconv.fused_modconv_level`` while
    ``on``: the input's shape and type, the output channels, whether noise
    is added, and whether autograd will run its backward (and ask for the
    weight's gradient)."""

    def __init__(self):
        self.on = False
        self.calls: List[Dict[str, Any]] = []

    @contextlib.contextmanager
    def installed(self):
        from gagan_tpu_torch.ops import fused_modconv as fmc

        orig = fmc.fused_modconv_level

        def level(x, w, styles, bias, noise=None, *args, **kwargs):
            if self.on:
                grad = torch.is_grad_enabled() and any(
                    t is not None and t.requires_grad
                    for t in (x, w, styles, bias, noise))
                self.calls.append(dict(
                    shape=tuple(x.shape), c_out=int(w.shape[0]),
                    dtype=str(x.dtype).replace("torch.", ""),
                    noise=noise is not None, backward=grad,
                    weight_grad=grad and w.requires_grad))
            return orig(x, w, styles, bias, noise, *args, **kwargs)

        fmc.fused_modconv_level = level
        try:
            yield self
        finally:
            fmc.fused_modconv_level = orig


def wrap_attr(module, name: str, make: Callable[[Callable], Callable]):
    """A context that replaces ``module.name`` by ``make(original)``."""
    @contextlib.contextmanager
    def ctx():
        orig = getattr(module, name)
        setattr(module, name, make(orig))
        try:
            yield
        finally:
            setattr(module, name, orig)
    return ctx()
