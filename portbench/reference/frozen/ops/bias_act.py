"""Fused bias + activation + gain + clamp (port of gagan_tpu/ops/bias_act.py).

Elementwise work that stays plain torch; this module fixes the semantics
(activation registry, default gains, clamping) exactly as the JAX module does,
including where bf16 rounds: the gain is cast to ``x.dtype`` before the
multiply.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


def _scalar(value: float, x: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``x.dtype`` first, as JAX treats a Python scalar
    (torch would multiply a bf16 tensor by the fp32 scalar).  Made by a fill
    on x's device: a scalar copied from the host would make the host wait
    for the card's queue to drain."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    func: Callable[..., torch.Tensor]
    def_alpha: float = 0.0
    def_gain: float = 1.0


activation_funcs = {
    "linear": ActivationSpec(func=lambda x, **_: x, def_alpha=0, def_gain=1),
    "relu": ActivationSpec(func=lambda x, **_: torch.relu(x), def_alpha=0,
                           def_gain=float(np.sqrt(2))),
    "lrelu": ActivationSpec(
        func=lambda x, alpha, **_: torch.where(x >= 0, x, x * _scalar(alpha, x)),
        def_alpha=0.2, def_gain=float(np.sqrt(2))),
    "tanh": ActivationSpec(func=lambda x, **_: torch.tanh(x), def_alpha=0,
                           def_gain=1),
    "sigmoid": ActivationSpec(func=lambda x, **_: torch.sigmoid(x),
                              def_alpha=0, def_gain=1),
    "elu": ActivationSpec(func=lambda x, **_: F.elu(x), def_alpha=0,
                          def_gain=1),
    "selu": ActivationSpec(func=lambda x, **_: F.selu(x), def_alpha=0,
                           def_gain=1),
    "softplus": ActivationSpec(
        func=lambda x, **_: torch.where(
            x > 20.0, x, torch.log1p(torch.exp(torch.clamp_max(x, 20.0)))),
        def_alpha=0, def_gain=1),
    "swish": ActivationSpec(func=lambda x, **_: torch.sigmoid(x) * x,
                            def_alpha=0, def_gain=float(np.sqrt(2))),
}


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    dim: int = 1,
    act: str = "linear",
    alpha: Optional[float] = None,
    gain: Optional[float] = None,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """Add per-channel bias ``b`` along ``dim``, apply ``act``, scale by
    ``gain`` (default: the activation's own) and clamp to ``[-clamp, clamp]``."""
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)

    if b is not None:
        if b.ndim != 1 or not 0 <= dim < x.ndim:
            raise ValueError(f"bias of shape {tuple(b.shape)} does not fit "
                             f"dim {dim} of x {tuple(x.shape)}")
        x = x + b.to(x.dtype).reshape(
            [-1 if i == dim else 1 for i in range(x.ndim)])

    x = spec.func(x, alpha=alpha)
    if gain != 1:
        x = x * _scalar(gain, x)
    if clamp is not None:
        if clamp < 0:
            raise ValueError(f"clamp must be >= 0, got {clamp}")
        x = torch.clamp(x, -clamp, clamp)
    return x
