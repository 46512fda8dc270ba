"""CLIP (ViT-B/32, ViT-B/16) image and text encoders of the port."""

from .model import (
    CLIPConfig,
    VIT_B_16,
    VIT_B_32,
    encode_image,
    encode_text,
    init_clip,
)

__all__ = [
    "CLIPConfig",
    "VIT_B_16",
    "VIT_B_32",
    "encode_image",
    "encode_text",
    "init_clip",
]
