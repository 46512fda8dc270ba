"""Latent editing: StyleSpace channel edits, InterFaceGAN directions and
the StyleFlow CNF editor (port of gagan_tpu/editing)."""

from .interfacegan import LatentEditor
from .stylespace import build_style_modification_hooks

__all__ = ["LatentEditor", "build_style_modification_hooks"]
