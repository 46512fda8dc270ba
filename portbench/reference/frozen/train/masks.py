"""Selective-training masks (port of gagan_tpu/train/masks.py): the
requires-grad-parts grammar as boolean trees over a parameter tree, keyed by
the dotted parameter paths (the reference's ``named_parameters()`` names).

Part grammar (each optionally suffixed `.b<res>`):
  all | mapping
  | synt_affine | synt_conv | synt_const | synt_offset | synt_weights_offset
  | synt_affine_weights_offset
  | tRGB_affine | tRGB_conv | tRGB_offset | tRGB_weights_offset
  | tRGB_affine_weights_offset
"""

from __future__ import annotations

import re
from typing import Any, Dict, Sequence, Tuple

# Buffers that never receive gradients regardless of parts.
_BUFFER_LEAVES = ("noise_const", "w_avg")

_PART_RE = re.compile(r"^([a-zA-Z_+]+)(?:\.b([0-9]+))?$")


def is_buffer(path: Tuple[str, ...]) -> bool:
    return path[-1] in _BUFFER_LEAVES


def _block_match(pname: str, res) -> bool:
    if res is None:
        return "synthesis" in pname
    return f"synthesis.b{res}" in pname


_FILTERS = {
    "mapping": lambda res: lambda p: "mapping" in p,
    "tRGB_affine": lambda res: lambda p: _block_match(p, res) and "torgb.affine" in p,
    "tRGB_conv": lambda res: lambda p: _block_match(p, res)
    and ("torgb.weight" in p or "torgb.bias" in p)
    and "affine" not in p and "offset" not in p,
    "tRGB_offset": lambda res: lambda p: _block_match(p, res)
    and "torgb.offset" in p and "torgb.weights_offset" not in p,
    "tRGB_weights_offset": lambda res: lambda p: _block_match(p, res)
    and "torgb.weights_offset" in p,
    "tRGB_affine_weights_offset": lambda res: lambda p: _block_match(p, res)
    and "torgb.affine.weights_offset" in p,
    "synt_affine": lambda res: lambda p: _block_match(p, res)
    and "conv" in p and "affine" in p,
    "synt_conv": lambda res: lambda p: _block_match(p, res)
    and "conv" in p
    and ("weight" in p or "noise_strength" in p or "bias" in p)
    and "affine" not in p and "offset" not in p,
    "synt_const": lambda res: lambda p: _block_match(p, res) and "const" in p,
    "synt_offset": lambda res: lambda p: _block_match(p, res)
    and "conv" in p and "offset" in p and "weights_offset" not in p,
    "synt_weights_offset": lambda res: lambda p: _block_match(p, res)
    and "conv" in p and "affine" not in p and "weights_offset" in p,
    "synt_affine_weights_offset": lambda res: lambda p: _block_match(p, res)
    and "conv" in p and "affine.weights_offset" in p,
}


def path_trainable(pname: str, parts: Sequence[str]) -> bool:
    if "all" in parts:
        return True
    for part in parts:
        m = _PART_RE.match(part)
        if m is None or m.group(1) not in _FILTERS:
            raise ValueError(f"Unknown requires-grad part: {part}")
        name, res = m.group(1), m.group(2)
        if _FILTERS[name](int(res) if res else None)(pname):
            return True
    return False


def _walk(node, path, fn):
    if isinstance(node, dict):
        return {k: _walk(v, path + (k,), fn) for k, v in node.items()}
    return fn(path)


def generator_mask(params: Dict[str, Any], parts: Sequence[str]) -> Dict[str, Any]:
    """Boolean mask over a generator params tree; buffers are always False."""

    def fn(path):
        if is_buffer(path):
            return False
        return path_trainable(".".join(path), parts)

    return _walk(params, (), fn)


def offsets_mask(offsets: Dict[str, Any], parts: Sequence[str]) -> Dict[str, Any]:
    """Mask over an offsets tree (layer names 'b<res>.conv0' etc.): each
    path is read with a 'synthesis.' prefix, so one parts grammar serves
    both trees."""

    def fn(path):
        return path_trainable("synthesis." + ".".join(path), parts)

    return _walk(offsets, (), fn)


def discriminator_mask(params: Dict[str, Any], parts: Sequence[str] = ("all",),
                       freeze_layers: int = 0) -> Dict[str, Any]:
    """D mask; ``freeze_layers`` freezes the first N conv layers from the top
    resolution down (Freeze-D)."""
    if freeze_layers <= 0:
        return _walk(params, (), lambda p: "all" in parts or
                     path_trainable(".".join(p), parts))

    # Layer order: per block (high res -> low): fromrgb?, conv0, conv1,
    # skip?; the epilogue is always trainable.
    order: Dict[str, int] = {}
    idx = 0
    resolutions = sorted(
        (int(k[1:]) for k in params if k.startswith("b") and k[1:].isdigit()),
        reverse=True)
    for res in resolutions:
        if res == 4:
            continue
        block = params[f"b{res}"]
        for lname in ("fromrgb", "conv0", "conv1", "skip"):
            if lname in block:
                order[f"b{res}.{lname}"] = idx
                idx += 1

    def fn(path):
        key = ".".join(path[:2])
        if key in order:
            return order[key] >= freeze_layers
        return True

    return _walk(params, (), fn)
