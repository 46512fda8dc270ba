"""Genetic-algorithm layer of the port: crossover / mutation primitives,
the GA metrics, the population search over StyleSpace directions, and the
in-training refinement of near-boundary fakes."""

from .crossover_mutation import (
    dynamic_mutation,
    gaussian_crossover,
    simulated_binary_crossover,
)
from .evaluation import calculate_metrics, make_alex_lpips
from .refine import apply_genetic_refinement, wgan_gradient_penalty
from .search import GASearchConfig, evolve_directions

__all__ = [
    "GASearchConfig",
    "apply_genetic_refinement",
    "calculate_metrics",
    "dynamic_mutation",
    "evolve_directions",
    "gaussian_crossover",
    "make_alex_lpips",
    "simulated_binary_crossover",
    "wgan_gradient_penalty",
]
