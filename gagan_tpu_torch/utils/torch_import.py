"""Import PyTorch StyleGAN2 state dicts into the port's parameter trees (port
of gagan_tpu/utils/torch_import.py).

The NVlabs state_dict layout maps by name, since the trees mirror it: a
dotted key becomes a nested path.  The buffers that the trees do not keep
(the resample filters, recomputed from the config, and the offsets system's
own masks) are dropped.  ``split_offsets`` moves offset leaves that a
reference generator registers inside its modules into a separate offsets
tree keyed by layer name.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# Buffers of the reference modules that have no equivalent in the trees
# (recomputed from the config, or owned by the offsets system).
_DROP_SUFFIXES = (
    "resample_filter",
    ".ones",
    ".ones_weights",
    ".offset_mask",
)


def _tensor(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to(device).clone()
    return torch.as_tensor(np.array(value), device=device)


def nest_state_dict(sd: Mapping[str, Any], device="cpu") -> Dict[str, Any]:
    """A flat dotted-key state dict -> a nested tree of tensors on
    ``device``, without the dropped buffers.  A key equal to a suffix
    without its dot (``ones``, ``offset_mask``) is dropped too, as in the
    JAX module."""
    out: Dict[str, Any] = {}
    for key, value in sd.items():
        if any(key.endswith(s) or s.strip(".") == key for s in _DROP_SUFFIXES):
            continue
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _tensor(value, device)
    return out


def generator_params_from_nvlabs(sd: Mapping[str, Any],
                                 device="cpu") -> Dict[str, Any]:
    """NVlabs ``Generator.state_dict()`` -> the port's generator tree."""
    return nest_state_dict(sd, device)


def discriminator_params_from_nvlabs(sd: Mapping[str, Any],
                                     device="cpu") -> Dict[str, Any]:
    """NVlabs ``Discriminator.state_dict()`` -> the port's discriminator
    tree."""
    return nest_state_dict(sd, device)


def split_offsets(params: Dict[str, Any]) -> Dict[str, Any]:
    """Move the offset leaves a reference generator keeps inside its layers
    (``offset``, ``weights_offset*`` and ``affine.weights_offset*``) into an
    offsets tree keyed ``b<res>.<layer>``.  Mutates ``params`` (removing
    those leaves) and returns the offsets tree."""
    offsets: Dict[str, Any] = {}
    synthesis = params.get("synthesis", params)
    for bname, block in synthesis.items():
        if not isinstance(block, dict):
            continue
        for lname, layer in block.items():
            if not isinstance(layer, dict):
                continue
            entry: Dict[str, Any] = {}
            for k in [k for k in layer if k == "offset"
                      or k.startswith("weights_offset")]:
                entry[k] = layer.pop(k)
            affine = layer.get("affine")
            if isinstance(affine, dict):
                aff_entry = {k: affine.pop(k) for k in
                             [k for k in affine if k.startswith("weights_offset")]}
                if aff_entry:
                    entry["affine"] = aff_entry
            if entry:
                offsets[f"{bname}.{lname}"] = entry
    return offsets
