"""Snapshots and adaptation checkpoints: the weight bridge between the two
packages (port of the npz helpers of gagan_tpu/utils/checkpoint.py).

A snapshot is one ``.npz``: every parameter tree flattened to dotted keys
under a ``G/``, ``D/``, ``G_ema/`` or ``extra/`` prefix, plus the config as
JSON bytes under ``__config__``.  An adaptation checkpoint is one ``.npz``
of an offsets tree under ``state_dict/``, optional ``extra_state/``, and
``__meta__`` JSON bytes (model_type, parametrization, sg2_params).  Both
formats are byte-for-byte the JAX package's, so a file written by either
package loads in the other.  Train-state checkpoints keep the JAX layout
(``ckpt_dir/step_NNNNNNNN``) in a format of the port's own.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
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


# ----------------------------------------------------------------------------
# Resumable train-state checkpoints
#
# The JAX package writes its state with orbax, which torch cannot read.  The
# port keeps its layout, ``ckpt_dir/step_{step:08d}``, as a directory holding
# ``state.pt``: ``torch.save`` of the state's leaves by path (dataclass
# fields, dict keys and list indices joined by "/"), written under a
# temporary name and renamed into place, so a crash never leaves a partial
# step behind.

_STATE_FILE = "state.pt"


def _state_leaves(obj: Any, prefix: str, out: Dict[str, Any]):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _state_leaves(getattr(obj, f.name), f"{prefix}{f.name}/", out)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _state_leaves(v, f"{prefix}{k}/", out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _state_leaves(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = obj


def train_state_leaves(state: Any) -> Dict[str, Any]:
    """{path: leaf} of a train state, the paths its checkpoint keys them
    by (dataclass fields, dict keys and list indices joined by "/")."""
    out: Dict[str, Any] = {}
    _state_leaves(state, "", out)
    return out


def _restore(like: Any, prefix: str, saved: Dict[str, Any]) -> Any:
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _restore(getattr(like, f.name), f"{prefix}{f.name}/",
                             saved) for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _restore(v, f"{prefix}{k}/", saved)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_restore(v, f"{prefix}{i}/", saved)
                          for i, v in enumerate(like))
    key = prefix[:-1]
    value = saved[key]
    if isinstance(like, torch.Tensor):
        if not isinstance(value, torch.Tensor) or value.shape != like.shape:
            raise ValueError(f"{key}: saved {getattr(value, 'shape', value)}"
                             f", expected shape {tuple(like.shape)}")
        return value.to(device=like.device, dtype=like.dtype)
    return value


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save_train_state(ckpt_dir: str, step: int, state: Any,
                     mesh=None) -> None:
    """Write ``state`` (dataclasses, dicts, lists, tensors and host
    scalars, such as a ``TrainState``) as step ``step`` of ``ckpt_dir``.
    With a ``mesh`` (``parallel/mesh.py``) rank 0 writes and every rank
    waits for it, so that each may then load the step."""
    if mesh is not None and mesh.rank != 0:
        mesh.barrier()
        return
    _write_train_state(ckpt_dir, step, state)
    if mesh is not None:
        mesh.barrier()


def _write_train_state(ckpt_dir: str, step: int, state: Any) -> None:
    final = _step_dir(ckpt_dir, step)
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    leaves = {k: v.detach().to("cpu", copy=True)
              if isinstance(v, torch.Tensor) else v
              for k, v in train_state_leaves(state).items()}
    torch.save(leaves, os.path.join(tmp, _STATE_FILE))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def load_train_state(ckpt_dir: str, step: int, like_state: Any) -> Any:
    """Step ``step`` of ``ckpt_dir`` rebuilt in the structure of
    ``like_state``, every tensor on the device and in the dtype of
    ``like_state``'s tensor at its place (as orbax restores onto an
    abstract state).  Raises on a missing or an extra leaf and on a tensor
    of another shape."""
    saved = torch.load(os.path.join(_step_dir(ckpt_dir, step), _STATE_FILE),
                       map_location="cpu", weights_only=True)
    want = train_state_leaves(like_state)
    missing, extra = set(want) - set(saved), set(saved) - set(want)
    if missing or extra:
        raise KeyError(f"train state step {step}: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    return _restore(like_state, "", saved)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None
