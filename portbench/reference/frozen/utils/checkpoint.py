"""Frozen copy of ``tree_to_flat_tensors`` (utils/checkpoint.py)."""

from __future__ import annotations

from typing import Any, Dict

import torch


def tree_to_flat_tensors(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict of tensors -> {dotted key: the same tensor} (no copy)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_to_flat_tensors(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def tree_to_device(tree: Any, device) -> Any:
    """Nested dicts and lists of tensors -> the same nesting with every
    tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to_device(v, device) for v in tree]
    return tree.to(device)
