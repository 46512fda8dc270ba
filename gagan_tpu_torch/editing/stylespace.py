"""StyleSpace channel edits (port of gagan_tpu/editing/stylespace.py).

A list of ((layer, channel), magnitude, offset_factor) edits becomes one
``style`` hook per edited layer of the port's ``LayerHooks``, composed with
a base hook of the same layer (a trained StyleSpace direction, say): either
the edit goes first and the base hook after it, or the base hook's change
of the styles is scaled by offset_factor on the edited channels and the
edit is added.  The edit's tensors are made on the host and moved to the
styles' device once per device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.stylegan2 import LayerHooks, SynthesisConfig

Modification = Tuple[Tuple[int, int], float, float]


class _OnDevice:
    """A host array, copied to each device it is asked for once."""

    def __init__(self, array: np.ndarray):
        self._host = torch.from_numpy(array)
        self._copies: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self._copies:
            self._copies[device] = self._host.to(device)
        return self._copies[device]


def build_style_modification_hooks(
    cfg: SynthesisConfig,
    modifications: Sequence[Modification],
    base_hooks: Optional[LayerHooks] = None,
    apply_first: bool = False,
) -> LayerHooks:
    """LayerHooks applying the S-space ``modifications`` (layer indices in
    ``cfg.layer_names()`` order).  With a base ``style`` hook on the layer:
    ``apply_first`` gives base(s + m); otherwise s + (base(s) - s) * f + m,
    f the offset factors (1 off the edited channels)."""
    names = cfg.layer_names()
    dims = cfg.layer_in_channels()
    per_layer: Dict[int, List[Modification]] = {}
    for (layer, channel), magnitude, factor in modifications:
        per_layer.setdefault(layer, []).append(
            ((layer, channel), magnitude, factor))

    hooks = {k: dict(v) for k, v in (base_hooks or {}).items()}
    for layer_idx, mods in per_layer.items():
        name = names[layer_idx]
        modification = np.zeros((1, dims[layer_idx]), np.float32)
        factors = np.ones((1, dims[layer_idx]), np.float32)
        for (_, channel), magnitude, factor in mods:
            modification[0, channel] = magnitude
            factors[0, channel] = factor
        m, f = _OnDevice(modification), _OnDevice(factors)

        prev = hooks.get(name, {}).get("style")
        if prev is not None and apply_first:
            def style_fn(s, p=prev, m=m):
                return p(s + m.on(s.device))
        elif prev is not None:
            def style_fn(s, p=prev, m=m, f=f):
                return s + (p(s) - s) * f.on(s.device) + m.on(s.device)
        else:
            def style_fn(s, m=m):
                return s + m.on(s.device)
        hooks.setdefault(name, {})["style"] = style_fn
    return hooks
