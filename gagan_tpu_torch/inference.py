"""(source, adapted) image pairs from a trained adaptation (port of
gagan_tpu/inference.py): load a snapshot and an adaptation checkpoint, and
render both generators on the same latents, optionally with MindTheGap's
latent mixing (the style latents replace w layers 7 and up).

Ported: the ``parametrization`` / ``offsets`` checkpoints (offsets trees
applied as layer hooks).  Not yet, each raising ``NotImplementedError``:
``original`` checkpoints, which replace generator weights (ROADMAP item
15), and the image-to-latent helpers ``project_e4e`` / ``project_restyle``
(the encoders, ROADMAP item 12).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import resolve_device
from .models import stylegan2 as sg2
from .params import offsets as offs_lib
from .utils import checkpoint as ckpt_lib
from .utils.config import generator_config_from_dict


class Inferencer:
    def __init__(self, adaptation_path: str, generator_path: str,
                 style_latents: Optional[np.ndarray] = None, device="cuda"):
        self.device = resolve_device(device)
        trees, config = ckpt_lib.load_snapshot(generator_path, self.device)
        self.g_params = trees.get("G_ema", trees.get("G"))
        self.g_cfg = generator_config_from_dict(config["g_cfg"])

        meta, offsets, extra = ckpt_lib.load_adaptation(adaptation_path,
                                                        self.device)
        self.model_type = meta["model_type"]
        self.parametrization = meta["parametrization"]
        if self.model_type == "original":
            raise NotImplementedError(
                "model_type 'original' (full generator weights) is not "
                "ported yet (ROADMAP item 15)")
        if self.model_type not in ("parametrization", "offsets"):
            raise ValueError(f"unsupported model_type {self.model_type}")
        self.spec = offs_lib.OffsetsSpec.from_string(self.parametrization)
        self.hooks = offs_lib.make_hooks(self.spec, offsets)

        self.style_latents = (torch.as_tensor(style_latents,
                                              dtype=torch.float32,
                                              device=self.device)
                              if style_latents is not None else None)
        if extra is not None and "style_latents" in extra:
            self.style_latents = extra["style_latents"]

    def _pair(self, ws: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        synth = self.g_params["synthesis"]
        with torch.no_grad():
            src = sg2.synthesis_apply(self.g_cfg.synthesis, synth, ws,
                                      noise_mode="const")
            trg = sg2.synthesis_apply(self.g_cfg.synthesis, synth, ws,
                                      noise_mode="const", hooks=self.hooks)
        return src, trg

    def __call__(self, z, truncation: float = 1.0,
                 mtg_mixing: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(source images, adapted images) in [-1, 1] for latents ``z``."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            ws = sg2.mapping_apply(self.g_cfg.mapping, self.g_params["mapping"],
                                   z, truncation_psi=truncation)
        if mtg_mixing and self.style_latents is not None:
            style = self.style_latents.float().expand(ws.shape)
            layer_idx = torch.arange(self.g_cfg.num_ws,
                                     device=self.device)[None, :, None]
            ws = torch.where(layer_idx < 7, ws, style)
        return self._pair(ws)

    def from_wplus(self, ws) -> Tuple[torch.Tensor, torch.Tensor]:
        """(source, adapted) renders of W+ latents [N, num_ws, w_dim]."""
        return self._pair(torch.as_tensor(ws, dtype=torch.float32,
                                          device=self.device))


def project_e4e(*args, **kwargs):
    raise NotImplementedError(
        "project_e4e needs the e4e encoder, not ported yet (ROADMAP item 12)")


def project_restyle(*args, **kwargs):
    raise NotImplementedError(
        "project_restyle needs the ReStyle encoder, not ported yet (ROADMAP "
        "item 12)")
