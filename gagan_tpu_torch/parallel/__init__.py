"""Multi-device helpers (port of gagan_tpu/parallel/).  The port runs on
one card: of ``parallel/spatial.py`` only ``merge_hooks`` is ported; data
parallelism and spatial sharding wait for ROADMAP item 10."""

from .spatial import merge_hooks

__all__ = ["merge_hooks"]
