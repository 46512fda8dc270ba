"""Models of the port: the StyleGAN2 generator and discriminator
(``stylegan2``), Swin-T (``swin``), and the model zoo's other generators
(``proggan``, ``sngan``, ``biggan``) behind the registry of ``zoo``."""

from . import biggan, proggan, sngan, zoo
from .stylegan2 import (
    DiscriminatorConfig,
    GeneratorConfig,
    MappingConfig,
    SynthesisConfig,
    discriminator_apply,
    generator_apply,
    generator_styles,
    init_discriminator,
    init_generator,
    mapping_apply,
    synthesis_apply,
    synthesis_from_styles,
)
from .zoo import GeneratorHandle, make_generator

__all__ = [
    "DiscriminatorConfig",
    "GeneratorConfig",
    "GeneratorHandle",
    "MappingConfig",
    "SynthesisConfig",
    "biggan",
    "discriminator_apply",
    "generator_apply",
    "generator_styles",
    "init_discriminator",
    "init_generator",
    "make_generator",
    "mapping_apply",
    "proggan",
    "sngan",
    "synthesis_apply",
    "synthesis_from_styles",
    "zoo",
]
