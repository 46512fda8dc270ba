"""Snapshots and adaptation checkpoints: the weight bridge between the two
packages (port of the npz helpers of gagan_tpu/utils/checkpoint.py).

A snapshot is one ``.npz``: every parameter tree flattened to dotted keys
under a ``G/``, ``D/``, ``G_ema/`` or ``extra/`` prefix, plus the config as
JSON bytes under ``__config__``.  An adaptation checkpoint is one ``.npz``
of an offsets tree under ``state_dict/``, optional ``extra_state/``, and
``__meta__`` JSON bytes (model_type, parametrization, sg2_params).  Both
formats are byte-for-byte the JAX package's, so a file written by either
package loads in the other.
"""

from __future__ import annotations

import json
import os
import re
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


def tree_to_device(tree: Any, device) -> Any:
    """Nested dicts and lists of tensors -> the same nesting with every
    tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to_device(v, device) for v in tree]
    return tree.to(device)


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


def save_adaptation(path: str, *, model_type: str, parametrization: str,
                    offsets: Any, sg2_config: Dict,
                    extra_state: Optional[Dict[str, Any]] = None):
    """model_type in {'original', 'mapper', 'parametrization', 'offsets'}."""
    arrays = {f"state_dict/{k}": v for k, v in tree_to_flat(offsets).items()}
    if extra_state:
        for k, v in tree_to_flat(extra_state).items():
            arrays[f"extra_state/{k}"] = v
    meta = {"model_type": model_type, "parametrization": parametrization,
            "sg2_params": sg2_config}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def _merge_layer_keys(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Re-join offsets layer names ('b<res>.<layer>') that dot-flattening
    split into two levels."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if re.match(r"^b\d+$", k) and isinstance(v, dict):
            for k2, v2 in v.items():
                out[f"{k}.{k2}"] = v2
        else:
            out[k] = v
    return out


def load_adaptation(path: str, device="cpu"):
    """(meta, offsets tree, extra_state tree or None), tensors on
    ``device``."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        state = {k[len("state_dict/"):]: data[k] for k in data.files
                 if k.startswith("state_dict/")}
        extra = {k[len("extra_state/"):]: data[k] for k in data.files
                 if k.startswith("extra_state/")}
    offsets = _merge_layer_keys(flat_to_tree(state, device))
    return meta, offsets, (flat_to_tree(extra, device) if extra else None)
