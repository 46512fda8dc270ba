"""InterFaceGAN latent editing (port of gagan_tpu/editing/interfacegan.py):
precomputed semantic directions added in W / W+ space."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


class LatentEditor:
    """Named directions (age, smile, rotation, ...) as float32 tensors on
    the CPU, each [w_dim] or [num_ws, w_dim]; an edit moves a direction to
    the latent's device."""

    def __init__(self, directions: Optional[Dict[str, np.ndarray]] = None):
        self.directions = {k: torch.as_tensor(np.asarray(v, np.float32))
                           for k, v in (directions or {}).items()}

    @classmethod
    def from_files(cls, paths: Dict[str, str]) -> "LatentEditor":
        """npz files holding ``direction``, else their first array."""
        directions = {}
        for name, path in paths.items():
            with np.load(path) as data:
                directions[name] = (data["direction"] if "direction" in data
                                    else data[data.files[0]])
        return cls(directions)

    def apply_interfacegan(self, latent: torch.Tensor, direction,
                           factor: float = 1.0,
                           factor_range: Optional[tuple] = None
                           ) -> torch.Tensor:
        """latent + factor * direction; with ``factor_range``, the latents of
        every factor in ``range(*factor_range)`` concatenated on the batch
        axis."""
        if isinstance(direction, str):
            direction = self.directions[direction]
        direction = torch.as_tensor(direction).to(latent.device)
        if factor_range is not None:
            return torch.cat([latent + f * direction
                              for f in range(*factor_range)])
        return latent + factor * direction

    def get_single_interface_gan_edits_with_direction(
            self, start_w: torch.Tensor, factors: Sequence[float],
            direction: str):
        return [self.apply_interfacegan(start_w, direction, f / 2)
                for f in factors]
