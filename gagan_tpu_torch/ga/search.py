"""GA search over StyleSpace directions (port of gagan_tpu/ga/search.py).

A direction is one flat vector over every synthesis layer's style width,
sliced in ``layer_names()`` order into additive ``style`` hooks.  Each
generation scores the population under ``fitness_fn(images) -> scalar``
(images: the candidate's ``batch_per_candidate`` renders in [0, 255] from
one z shared by all candidates, const noise), keeps the elite, and fills
the rest with Gaussian crossovers of parents drawn from the top half,
mutated.  ``eval_mode="scan"`` renders one candidate per generator call;
``"batched"`` renders the whole population in one call with per-sample
style offsets and applies ``fitness_fn`` per candidate with
``torch.func.vmap``.  The key tree (``utils/rng.py``'s interface) is split
in the JAX module's order, so injected JAX draws give the JAX run.

With a ``mesh`` (``parallel/mesh.py``) the population is split into
contiguous blocks over the ranks: each rank scores its block, the scores
are gathered to every rank, and selection runs on them from the same key
everywhere, so every rank returns the one-process result.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import stylegan2 as sg2
from ..parallel.mesh import share_rows
from ..utils.observability import trace_scope
from .crossover_mutation import dynamic_mutation, gaussian_crossover

Params = Dict


def style_dims(syn_cfg: sg2.SynthesisConfig) -> List[int]:
    return syn_cfg.layer_in_channels()


def direction_dim(syn_cfg: sg2.SynthesisConfig) -> int:
    return sum(style_dims(syn_cfg))


def direction_to_hooks(syn_cfg: sg2.SynthesisConfig,
                       direction: torch.Tensor) -> sg2.LayerHooks:
    """Flat direction [D] -> additive StyleSpace hooks (s_delta).  With
    ``direction`` [B, D], row b is added to sample b's styles."""
    hooks = {}
    start = 0
    for name, d in zip(syn_cfg.layer_names(), style_dims(syn_cfg)):
        seg = direction[..., start:start + d]
        hooks[name] = {"style": (lambda s, o=seg: s + o.to(s.dtype))}
        start += d
    return hooks


def batched_direction_hooks(syn_cfg: sg2.SynthesisConfig,
                            directions: torch.Tensor) -> sg2.LayerHooks:
    """Per-sample hooks: ``directions`` [B, D] applies row b to sample b,
    so the whole population rides one generator batch."""
    if directions.ndim != 2:
        raise ValueError(f"directions must be [B, D], got "
                         f"{tuple(directions.shape)}")
    return direction_to_hooks(syn_cfg, directions)


@dataclasses.dataclass(frozen=True)
class GASearchConfig:
    population: int = 32
    generations: int = 10
    elite: int = 4
    batch_per_candidate: int = 4
    mutation_rate: float = 0.1
    init_sigma: float = 1.0
    truncation_psi: float = 0.7
    # 'scan': one candidate per generator call; 'batched': the population
    # in one [population * batch_per_candidate] call.  Equal scores.
    eval_mode: str = "scan"


def render(g_cfg, g_params, z, psi, hooks) -> torch.Tensor:
    """The candidates' images in [0, 255] (float), const noise; a profiler
    range "ga_render"."""
    with trace_scope("ga_render"):
        img = sg2.generator_apply(g_cfg, g_params, z, truncation_psi=psi,
                                  noise_mode="const", hooks=hooks)
        return torch.clamp(img * 127.5 + 128, 0, 255)


def _fitness(fitness_fn, images):
    with trace_scope("ga_fitness"):
        return fitness_fn(images)


def eval_scan(cfg, g_cfg, g_params, fitness_fn, population, z):
    """Scores [population]: one generator call per candidate."""
    return torch.stack([
        _fitness(fitness_fn, render(g_cfg, g_params, z, cfg.truncation_psi,
                                    direction_to_hooks(g_cfg.synthesis, d)))
        for d in population])


def eval_batched(cfg, g_cfg, g_params, fitness_fn, population, z):
    """Scores [population]: one generator call on the population's
    ``population * batch_per_candidate`` samples (per-sample style offsets,
    ``z`` tiled), then ``fitness_fn`` vmapped over the candidates."""
    b, pop = cfg.batch_per_candidate, population.shape[0]
    dirs_rep = population.repeat_interleave(b, dim=0)    # candidate-major
    img = render(g_cfg, g_params, z.repeat(pop, 1), cfg.truncation_psi,
                 batched_direction_hooks(g_cfg.synthesis, dirs_rep))
    return _fitness(torch.func.vmap(fitness_fn),
                    img.reshape((pop, b) + img.shape[1:]))


EVALUATE = {"scan": eval_scan, "batched": eval_batched}


def next_generation(cfg: GASearchConfig, population: torch.Tensor,
                    scores: torch.Tensor, key) -> torch.Tensor:
    """Elite first, then mutated crossovers of parents from the top half
    (one key per child for each of the two draws)."""
    order = torch.argsort(-scores, stable=True)          # descending fitness
    elite = population[order[: cfg.elite]]
    n_children = cfg.population - cfg.elite
    k_p1, k_p2, k_cx, k_mut = key.split(4)
    top_half = population[order[: max(cfg.population // 2, 2)]]
    dev = population.device
    p1 = top_half[k_p1.randint((n_children,), 0, top_half.shape[0], dev)]
    p2 = top_half[k_p2.randint((n_children,), 0, top_half.shape[0], dev)]
    children = [gaussian_crossover(k, a, b)
                for k, a, b in zip(k_cx.split(n_children), p1, p2)]
    children = [dynamic_mutation(k, x, cfg.mutation_rate)
                for k, x in zip(k_mut.split(n_children), children)]
    return torch.cat([elite, torch.stack(children)], dim=0)


def evolve_directions(
    key,
    g_cfg: sg2.GeneratorConfig,
    g_params: Params,
    fitness_fn: Callable[[torch.Tensor], torch.Tensor],
    cfg: GASearchConfig = GASearchConfig(),
    mesh=None,
    progress: Optional[Callable] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Evolve StyleSpace directions maximising ``fitness_fn(images)``, on
    the device of ``g_params``, from the key ``key`` (an ``Rng``), the
    population's scoring split over the ranks of ``mesh``; only rank 0
    calls ``progress``.  Returns (best direction [D], history of each
    generation's best score [generations])."""
    if cfg.eval_mode not in EVALUATE:
        raise ValueError(f"eval_mode must be 'scan' or 'batched', got "
                         f"{cfg.eval_mode!r}")
    score = EVALUATE[cfg.eval_mode]
    rows = None
    if mesh is not None and mesh.sharded:
        rows = share_rows(cfg.population, mesh.world_size, mesh.rank)

    def evaluate(population, z):
        if rows is None:
            return score(cfg, g_cfg, g_params, fitness_fn, population, z)
        return mesh.gather(score(cfg, g_cfg, g_params, fitness_fn,
                                 population[rows], z), rows, cfg.population)

    device = g_params["synthesis"]["b4"]["const"].device
    dim = direction_dim(g_cfg.synthesis)
    b = cfg.batch_per_candidate
    key, k_init = key.split(2)
    population = k_init.normal((cfg.population, dim), device) * cfg.init_sigma

    history = []
    with torch.no_grad():
        for gen in range(cfg.generations):
            key, k_z, k_n, k_next = key.split(4)
            z = k_z.normal((b, g_cfg.z_dim), device)
            scores = evaluate(population, z)
            history.append(float(scores.max()))
            if progress is not None and (rows is None or mesh.rank == 0):
                progress(gen, history[-1])
            population = next_generation(cfg, population, scores, k_next)

        key, k_z, k_n = key.split(3)
        z = k_z.normal((b, g_cfg.z_dim), device)
        scores = evaluate(population, z)
        best = population[torch.argmax(scores)]
    return best.cpu().numpy(), np.asarray(history)
