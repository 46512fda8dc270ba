"""Hook composition (port of ``merge_hooks`` of
gagan_tpu/parallel/spatial.py).

The JAX module's spatial (height) sharding of synthesis over a device mesh
is not ported: its functions raise ``NotImplementedError`` naming the next
slice of ROADMAP item 10 (data parallelism, ``parallel/mesh.py``, is
ported).
"""

from __future__ import annotations

from typing import Optional

from ..models.stylegan2 import LayerHooks


def merge_hooks(base: Optional[LayerHooks],
                extra: LayerHooks) -> LayerHooks:
    """Compose two hook trees; where both define the same slot, ``base``
    runs first and ``extra`` wraps its result."""
    if not base:
        return extra
    merged: LayerHooks = {k: dict(v) for k, v in base.items()}
    for lname, slots in extra.items():
        dst = merged.setdefault(lname, {})
        for kind, fn in slots.items():
            if kind in dst:
                prev = dst[kind]
                dst[kind] = (lambda v, p=prev, f=fn: f(p(v)))
            else:
                dst[kind] = fn
    return merged


def _multi_device(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: spatial sharding over several devices is not ported "
            f"yet (the next slice of ROADMAP item 10)")
    refuse.__name__ = name
    return refuse


spatial_sharding_hooks = _multi_device("spatial_sharding_hooks")
d_spatial_constraint = _multi_device("d_spatial_constraint")
spatial_synthesis_fn = _multi_device("spatial_synthesis_fn")
