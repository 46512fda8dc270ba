"""Genetic-algorithm layer of the port: crossover / mutation primitives and
the in-training refinement of near-boundary fakes."""

from .crossover_mutation import (
    dynamic_mutation,
    gaussian_crossover,
    simulated_binary_crossover,
)
from .refine import apply_genetic_refinement, wgan_gradient_penalty

__all__ = [
    "apply_genetic_refinement",
    "dynamic_mutation",
    "gaussian_crossover",
    "simulated_binary_crossover",
    "wgan_gradient_penalty",
]
