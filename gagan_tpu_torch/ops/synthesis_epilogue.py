"""The synthesis layers' epilogue as one pass: demodulate, noise, bias,
leaky ReLU times its gain, clamp.

    y = clamp(gain * lrelu_alpha(c * d[n, o] + noise[n', o // (C/P)] + b[o]),
              -clamp, clamp)

over the modulated convolution's output ``c`` [N, C, H, W] before
demodulation.  The composed chain (``ops/modulated_conv2d.py``'s
demodulation multiply and noise add, then ``ops/bias_act.py``) moves about
17 bytes for every byte of ``c``; the kernel (``csrc/synthesis_epilogue.cu``)
reads ``c`` once and writes ``y`` once.  It replaces no TPU kernel: the JAX
package leaves the chain to XLA's fusion, which eager PyTorch lacks.

The arithmetic is fp32, the result rounded once to ``c``'s dtype; ``alpha``
and ``gain`` are rounded to that dtype first, as ``bias_act`` rounds them.
``synthesis_epilogue`` runs the kernel on CUDA tensors and its plain
PyTorch version ``synthesis_epilogue_ref`` on CPU tensors; a CUDA tensor
never takes the plain version.  Forward only: :func:`applies` keeps every
call that would record an autograd graph on the composed path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..utils import observability
from .bias_act import activation_funcs

LRELU_ALPHA = activation_funcs["lrelu"].def_alpha
LRELU_GAIN = activation_funcs["lrelu"].def_gain
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def applies(x: torch.Tensor, activation: str, *tensors) -> bool:
    """Whether a synthesis layer's epilogue takes the kernel: ``x``, its
    conv output, a float32 or bfloat16 CUDA tensor, the leaky ReLU, and no
    autograd graph to record (grad mode off, or none of ``x`` and
    ``tensors``, the layer's bias and scaled noise, requires grad; ``x``
    does when the layer's input, styles or weight do).  Otherwise the
    composed ops run, with their backward."""
    if not (x.is_cuda and x.dtype in _DTYPES and activation == "lrelu"):
        return False
    return not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, *tensors)))


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (exact in float32 after)."""
    return float(torch.tensor(value, dtype=dtype))


def _noise_planes(noise: torch.Tensor, channels: int) -> torch.Tensor:
    """noise [n', P, H, W] -> [n', C, H, W]: channel o reads plane
    o // (C/P)."""
    p = noise.shape[1]
    return noise if p == 1 else noise.repeat_interleave(channels // p, dim=1)


def synthesis_epilogue_ref(c, d, b, noise=None, alpha=LRELU_ALPHA,
                           gain=LRELU_GAIN,
                           clamp: Optional[float] = 256.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same fp32 operations in the
    same order, rounded once to ``c``'s dtype."""
    alpha, gain = _rounded(alpha, c.dtype), _rounded(gain, c.dtype)
    v = c.float() * d.float()[:, :, None, None]
    if noise is not None:
        v = v + _noise_planes(noise, c.shape[1]).float()
    v = v + b.float()[None, :, None, None]
    v = torch.where(v >= 0, v, v * alpha)
    v = v * gain
    if clamp is not None:
        v = torch.clamp(v, -clamp, clamp)
    return v.to(c.dtype)


def _check(c, d, b, noise):
    if c.dtype not in _DTYPES:
        raise TypeError(f"synthesis_epilogue takes float32 or bfloat16 c, "
                        f"got {c.dtype}")
    if c.ndim != 4 or not c.is_contiguous():
        raise ValueError(f"c must be a contiguous [N, C, H, W] tensor, got "
                         f"{tuple(c.shape)} strides {c.stride()}")
    n, ch, h, w = c.shape
    want = {"d": (d, (n, ch), torch.float32), "b": (b, (ch,), torch.float32)}
    if noise is not None:
        if (noise.ndim != 4 or noise.shape[0] not in (1, n)
                or noise.shape[1] < 1 or ch % noise.shape[1]
                or tuple(noise.shape[2:]) != (h, w)):
            raise ValueError(f"noise {tuple(noise.shape)} does not fit c "
                             f"{tuple(c.shape)}: [1 or N, P, H, W], P "
                             f"dividing C")
        want["noise"] = (noise, tuple(noise.shape), c.dtype)
    for name, (t, shape, dtype) in want.items():
        if t.device != c.device:
            raise ValueError(f"{name} is on {t.device}, c on {c.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib():
    from .. import _build

    lib = _build.load("synthesis_epilogue")
    if lib.gagan_synthesis_epilogue.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.gagan_synthesis_epilogue.argtypes = [
            i, p, p, p, p, p, ll, i, ll, i, ll, f, f, f, i, p]
        lib.gagan_synthesis_epilogue.restype = i
    return lib


def nbytes(c, d, b, noise=None) -> int:
    """The bytes one launch has to move: c read, y written, the noise
    planes, d and b read once."""
    total = 2 * c.numel() * c.element_size() + 4 * (d.numel() + b.numel())
    if noise is not None:
        total += noise.numel() * noise.element_size()
    return total


def synthesis_epilogue(c, d, b, noise=None, alpha=LRELU_ALPHA, gain=LRELU_GAIN,
                       clamp: Optional[float] = 256.0) -> torch.Tensor:
    """The epilogue of a synthesis layer, one pass (module docstring).

    c [N, C, H, W] float32 or bfloat16, contiguous; d [N, C] and b [C]
    float32; noise [1 or N, P, H, W] in c's dtype (scaled by the noise
    strength), or None.  Not differentiable."""
    if c.device.type == "cpu":
        return synthesis_epilogue_ref(c, d, b, noise, alpha, gain, clamp)
    if c.device.type != "cuda":
        raise ValueError(f"synthesis_epilogue runs on CUDA or CPU, not "
                         f"{c.device}")
    _check(c, d, b, noise)
    n, ch, h, w = c.shape
    with torch.cuda.device(c.device):
        y = torch.empty_like(c)
        status = _lib().gagan_synthesis_epilogue(
            _DTYPES[c.dtype], c.data_ptr(), d.data_ptr(), b.data_ptr(),
            noise.data_ptr() if noise is not None else None, y.data_ptr(),
            n * ch, ch, h * w, noise.shape[1] if noise is not None else 1,
            (noise.shape[1] * h * w
             if noise is not None and noise.shape[0] > 1 else 0),
            _rounded(alpha, c.dtype), _rounded(gain, c.dtype),
            float(clamp) if clamp is not None else 0.0, int(clamp is not None),
            torch.cuda.current_stream(c.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"synthesis_epilogue launch failed: CUDA error "
                           f"{status}")
    synthesis_epilogue.launches += 1
    if observability.is_recording():
        synthesis_epilogue.traced_bytes += nbytes(c, d, b, noise)
    return y


synthesis_epilogue.launches = 0      # kernel launches since the last reset
# Bytes the launches made while the port's spans record (a profiled
# window) had to move; read by the benchmark's epilogue roofline.
synthesis_epilogue.traced_bytes = 0
