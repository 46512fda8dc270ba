"""GA primitives (port of gagan_tpu/ga/crossover_mutation.py); each draws
from a key of utils/rng.py."""

from __future__ import annotations

import torch


def gaussian_crossover(key, parent1: torch.Tensor,
                       parent2: torch.Tensor) -> torch.Tensor:
    """child = mu * p1 + (1 - mu) * p2, elementwise mu ~ N(0, 1)."""
    mu = key.normal(parent1.shape, device=parent1.device).to(parent1.dtype)
    return mu * parent1 + (1 - mu) * parent2


def simulated_binary_crossover(key, parent1: torch.Tensor,
                               parent2: torch.Tensor):
    """beta ~ U[0,1); children = 0.5((1±beta) p1 + (1∓beta) p2)."""
    beta = key.uniform((), device=parent1.device).to(parent1.dtype)
    child1 = 0.5 * ((1 + beta) * parent1 + (1 - beta) * parent2)
    child2 = 0.5 * ((1 - beta) * parent1 + (1 + beta) * parent2)
    return child1, child2


def dynamic_mutation(key, features: torch.Tensor,
                     mutation_rate: float = 0.1) -> torch.Tensor:
    """x + rate * N(0,1)."""
    return features + mutation_rate * key.normal(
        features.shape, device=features.device).to(features.dtype)
