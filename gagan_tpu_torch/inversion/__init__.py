"""Latent inversion of the port: the LPIPS projector, II2S, the
single-pass pSp / e4e encoders and the iterative ReStyle family, and the
latent adversary of e4e training."""

from .encoders import (
    EncoderConfig,
    e4e_encode,
    encode_image_to_wplus,
    init_encoder,
    psp_encode,
)
from .projector import noise_regularization, project
from .restyle import (
    RestyleEncoderConfig,
    RestyleNet,
    get_avg_image,
    init_restyle_encoder,
    load_net,
    restyle_encode,
    run_on_batch,
)

__all__ = [
    "EncoderConfig",
    "RestyleEncoderConfig",
    "RestyleNet",
    "e4e_encode",
    "encode_image_to_wplus",
    "get_avg_image",
    "init_encoder",
    "init_restyle_encoder",
    "load_net",
    "noise_regularization",
    "project",
    "psp_encode",
    "restyle_encode",
    "run_on_batch",
]
