"""Latent inversion of the port: the LPIPS projector and the single-pass
pSp / e4e encoders.  The iterative ReStyle family and II2S are not ported
yet (ROADMAP item 12)."""

from .encoders import (
    EncoderConfig,
    e4e_encode,
    encode_image_to_wplus,
    init_encoder,
    psp_encode,
)
from .projector import noise_regularization, project

__all__ = [
    "EncoderConfig",
    "e4e_encode",
    "encode_image_to_wplus",
    "init_encoder",
    "noise_regularization",
    "project",
    "psp_encode",
]
