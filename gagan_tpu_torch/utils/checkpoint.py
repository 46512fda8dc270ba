"""Snapshots: the weight bridge between the two packages (port of the flat
npz <-> tree helpers of gagan_tpu/utils/checkpoint.py).

A snapshot is one ``.npz``: every parameter tree flattened to dotted keys
under a ``G/``, ``D/``, ``G_ema/`` or ``extra/`` prefix, plus the config as
JSON bytes under ``__config__``.  The format is byte-for-byte the JAX
package's, so a snapshot written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, prefix + k + ".", out)
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)


def tree_to_flat(tree: Any) -> Dict[str, np.ndarray]:
    """Nested dict of tensors/arrays -> {dotted key: numpy array}."""
    out: Dict[str, np.ndarray] = {}
    _flatten(tree, "", out)
    return out


def tree_to_flat_tensors(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict of tensors -> {dotted key: the same tensor} (no copy)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_to_flat_tensors(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def flat_to_tree(flat: Dict[str, np.ndarray], device="cpu") -> Dict[str, Any]:
    """{dotted key: array} -> nested dict of tensors on ``device``."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(np.array(value), device=device)
    return tree


def save_snapshot(path: str, *, g_params=None, d_params=None, g_ema=None,
                  config: Optional[Dict] = None, extra: Optional[Dict] = None):
    """Write a network snapshot: npz of all trees + embedded config JSON."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for name, tree in (("G", g_params), ("D", d_params), ("G_ema", g_ema)):
        if tree is not None:
            for k, v in tree_to_flat(tree).items():
                arrays[f"{name}/{k}"] = v
    if extra:
        for k, v in tree_to_flat(extra).items():
            arrays[f"extra/{k}"] = v
    meta = json.dumps(config or {})
    arrays["__config__"] = np.frombuffer(meta.encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_snapshot(path: str, device="cpu"):
    """Returns (trees, config); trees maps G/D/G_ema/extra -> tensor tree."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    config = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if key == "__config__":
                config = json.loads(bytes(data[key]).decode())
                continue
            group, rest = key.split("/", 1)
            groups.setdefault(group, {})[rest] = data[key]
    trees = {g: flat_to_tree(flat, device) for g, flat in groups.items()}
    return trees, config
