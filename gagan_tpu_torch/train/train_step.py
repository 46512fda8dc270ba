"""The ADA training step family (port of gagan_tpu/train/train_step.py): the
G/D phases with lazy regularization, gradient-accumulation rounds, EMA,
the ``w_avg`` / ``pl_mean`` updates, ADA and the GA splice.

* Phases (Gmain / Greg / Dmain / Dreg, or the simultaneous Gmain+Dmain) are
  plain functions of a :class:`TrainState`; the caller schedules the reg
  phases every ``*_reg_interval`` batches by picking one of the fused step
  variants (``make_fused_step(do_g_reg=..., do_d_reg=...)``).
* The optimizers are optax's ``adam`` with the lazy-regularization scaling
  (lr * mb_ratio, betas ** mb_ratio), masked so that frozen leaves get no
  update and no state (:class:`Adam`).
* Rounds AVERAGE the per-round gradients and metrics, as the JAX module does
  (a deliberate deviation from the reference's sum; see
  ``TrainConfig.accum_rounds``).
* With an offsets spec and optimizer (domain adaptation: Affine+,
  AffineLight+, StyleSpace+), every G phase differentiates G's trainable
  leaves and the trainable offsets together under the offsets' hooks, and
  the offsets take their own masked Adam step after G's; Dmain runs G under
  the hooks without gradients; the offsets keep an EMA of their own.

Unlike the JAX module's pure functions, the steps update the state's
tensors in place (parameters, EMA, optimizer moments) to save device memory,
and return the same state object.  Gradients are taken by flagging the
trainable leaves ``requires_grad`` for the length of a phase.

Every step takes a ``mesh`` (``parallel/mesh.py``; ``shard_train_step``
binds it) and then runs as one rank of a data-parallel world: the real
images are the rank's share, laid out in :func:`data_rounds` rounds; ``z``,
``gen_c`` and the key are the global ones.  Each round runs the rank's
rows with the global batch's draws, and each phase averages its gradients
and metrics over the ranks in one ``all_reduce`` before Adam, so the step
is the one-process step on the global batch.

Spatial (height) sharding (``parallel/spatial.py``) is the other way to
spread a step over ranks: ``extra_hooks`` (``spatial_sharding_hooks``) are
merged after the offsets hooks on every G forward and ``d_constraint``
(``d_spatial_constraint``) goes to every D call.  The step is then called
without a mesh: every rank runs the whole batch with the same draws and
holds the large maps' rows only, and the gradients leave the backward whole
on every rank (the row layers' ``enter`` sums them over the ranks), so no
phase averages anything over the ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models import stylegan2 as sg2
from ..parallel import mesh as mesh_lib
from ..parallel import spatial as spatial_lib
from ..params import offsets as offs_lib
from ..utils.checkpoint import tree_to_flat_tensors
from ..utils.observability import trace_scope
from . import gan_loss, masks as masks_lib

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    g_lr: float = 0.0025
    d_lr: float = 0.0025
    adam_beta1: float = 0.0
    adam_beta2: float = 0.99
    adam_eps: float = 1e-8
    g_reg_interval: Optional[int] = 4
    d_reg_interval: Optional[int] = 16
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = None
    ada_target: Optional[float] = None    # None = no ADA adjustment
    ada_interval: int = 4
    ada_kimg: float = 500.0
    batch_size: int = 32                  # global batch (for EMA/ADA rates)
    loss: gan_loss.GANLossConfig = dataclasses.field(
        default_factory=gan_loss.GANLossConfig)
    g_requires_grad_parts: Tuple[str, ...] = ("all",)
    d_requires_grad_parts: Tuple[str, ...] = ("all",)
    freeze_d_layers: int = 0
    # Gradient accumulation: each phase splits its batch into this many
    # sequential rounds and AVERAGES the gradients (the reference sums them;
    # averaging keeps the step invariant to the round count).
    accum_rounds: int = 1
    reg_accum_rounds: Optional[int] = None    # default: accum_rounds
    g_reg_accum_rounds: Optional[int] = None  # default: reg_accum_rounds
    d_reg_accum_rounds: Optional[int] = None  # default: reg_accum_rounds
    # The JAX package's choice between a lax.scan and an unrolled loop; the
    # port's rounds are a Python loop either way.
    accum_scan: bool = True
    # Gmain+Dmain as one simultaneous update over a shared G forward
    # (gan_loss.gd_main_loss); False runs the reference's alternating phases.
    simultaneous_main: bool = False
    # GA-GAN in-training refinement: fakes whose |D(real)-D(fake)| <
    # ga_threshold are replaced by GA offspring before D scores them.
    ga_threshold: Optional[float] = None
    ga_mutation_rate: float = 0.1


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Dict[str, torch.Tensor]       # by dotted path, trainable leaves only
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.adam (eps outside the square root, bias-corrected moments),
    applied to the leaves whose dotted path maps to True in ``mask``; the
    others get no update and keep no state (the JAX ``_masked``).  An empty
    mask trains every leaf."""
    lr: float
    b1: float
    b2: float
    eps: float
    mask: Tuple[Tuple[str, bool], ...] = ()

    def trainable(self, params: Params) -> Dict[str, torch.Tensor]:
        flat = tree_to_flat_tensors(params)
        if not self.mask:
            return flat
        mask = dict(self.mask)
        return {k: v for k, v in flat.items() if mask[k]}

    def init(self, params: Params) -> AdamState:
        leaves = self.trainable(params)
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(v) for k, v in leaves.items()},
            nu={k: torch.zeros_like(v) for k, v in leaves.items()})

    @torch.no_grad()
    def update_(self, grads: Dict[str, torch.Tensor], state: AdamState,
                params: Params) -> AdamState:
        """Apply one step in place to ``params`` and ``state``."""
        state.count += 1
        bc1 = 1.0 - self.b1 ** state.count
        bc2 = 1.0 - self.b2 ** state.count
        for k, p in self.trainable(params).items():
            g = grads[k]
            mu = state.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu = state.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps))
        return state


@dataclasses.dataclass
class TrainState:
    g_params: Params
    d_params: Params
    g_ema: Params
    g_opt_state: AdamState
    d_opt_state: AdamState
    pl_mean: torch.Tensor
    ada_p: torch.Tensor
    cur_nimg: int                        # image counter (host int)
    # The offsets parameterization of domain adaptation, trained with the
    # unfrozen generator parts in the G phases.
    offsets: Optional[Params] = None
    offsets_ema: Optional[Params] = None
    offsets_opt_state: Optional[AdamState] = None


def _lazy_scaled_adam(lr: float, betas: Tuple[float, float], eps: float,
                      reg_interval: Optional[int]) -> Adam:
    if reg_interval is not None:
        mb_ratio = reg_interval / (reg_interval + 1)
        lr = lr * mb_ratio
        betas = tuple(beta ** mb_ratio for beta in betas)
    return Adam(lr, betas[0], betas[1], eps)


def _masked(tx: Adam, mask: Params) -> Adam:
    """``tx`` on the mask=True leaves only; the others stay as they are."""
    flat = tree_to_flat_tensors(mask)
    return dataclasses.replace(tx, mask=tuple(sorted(flat.items())))


def _scrub(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """nan_to_num gradient scrub (training_loop.py:508-510)."""
    return {k: torch.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5)
            for k, g in grads.items()}


def _chunk(x: Optional[torch.Tensor], rounds: int, r: int):
    """Round ``r``'s chunk of the leading (batch) axis."""
    if x is None or rounds <= 1:
        return x
    if x.shape[0] % rounds:
        raise ValueError(
            f"accumulation rounds ({rounds}) must divide the phase batch "
            f"({x.shape[0]}); a remainder would be silently dropped")
    n = x.shape[0] // rounds
    return x[r * n:(r + 1) * n]


def _rounds(cfg: TrainConfig) -> Tuple[int, int, int]:
    """The (main, Greg, Dreg) accumulation rounds."""
    reg_default = cfg.reg_accum_rounds or cfg.accum_rounds
    return (max(cfg.accum_rounds, 1),
            max(cfg.g_reg_accum_rounds or reg_default, 1),
            max(cfg.d_reg_accum_rounds or reg_default, 1))


def data_rounds(cfg: TrainConfig) -> int:
    """The rounds in which a rank's share of the real images is laid out
    (``parallel.mesh.share_rows``): a multiple of the rounds of both phases
    that read them, Dmain and Dreg, so that each of their rounds is a whole
    number of the rank's blocks."""
    main, _, d_reg = _rounds(cfg)
    return math.lcm(main, d_reg)


def _mesh_mean(mesh, *trees: Dict[str, torch.Tensor]):
    """Each tensor of the dicts ``trees`` averaged over the mesh's ranks,
    in one all_reduce of a flat fp32 bucket."""
    bucket = torch.cat([v.detach().reshape(-1).float()
                        for t in trees for v in t.values()])
    mesh.all_reduce_(bucket).div_(mesh.world_size)
    out, offset = [], 0
    for t in trees:
        out.append({})
        for k, v in t.items():
            out[-1][k] = bucket[offset:offset + v.numel()].view(
                v.shape).to(v.dtype)
            offset += v.numel()
    return out


def _accum(run_round: Callable, rounds: int, key,
           leaves: Dict[str, torch.Tensor], mesh=None):
    """Average the metrics and the gradients (with respect to ``leaves``)
    of ``run_round(r, key_r) -> (loss, metrics)`` over ``rounds``
    sequential chunks, then over the ranks of a sharded ``mesh``; with one
    round the caller's key passes through.  Returns (metrics, grads)."""
    for t in leaves.values():
        t.requires_grad_(True)
        t.grad = None
    acc: Dict[str, torch.Tensor] = {}
    try:
        for r in range(max(rounds, 1)):
            loss, metrics = run_round(r, key if rounds <= 1 else key.fold_in(r))
            with trace_scope("step.backward"):
                loss.backward()
            # Freeing the round's autograd graph is host time of its own.
            with trace_scope("step.free_graph"):
                del loss
            for k, v in metrics.items():
                acc[k] = v if k not in acc else acc[k] + v
        n = float(max(rounds, 1))
        with trace_scope("step.grads"):
            grads = {k: (t.grad / n if t.grad is not None
                         else torch.zeros_like(t)) for k, t in leaves.items()}
    finally:
        for t in leaves.values():
            t.grad = None
            t.requires_grad_(False)
    metrics = {k: v / n for k, v in acc.items()}
    if mesh is not None and mesh.sharded:
        metrics, grads = _mesh_mean(mesh, metrics, grads)
    return metrics, grads


def build_optimizers(cfg: TrainConfig, g_params: Params, d_params: Params):
    g_mask = masks_lib.generator_mask(g_params, cfg.g_requires_grad_parts)
    d_mask = masks_lib.discriminator_mask(
        d_params, cfg.d_requires_grad_parts, cfg.freeze_d_layers)
    betas = (cfg.adam_beta1, cfg.adam_beta2)
    g_tx = _masked(_lazy_scaled_adam(cfg.g_lr, betas, cfg.adam_eps,
                                     cfg.g_reg_interval), g_mask)
    d_tx = _masked(_lazy_scaled_adam(cfg.d_lr, betas, cfg.adam_eps,
                                     cfg.d_reg_interval), d_mask)
    return g_tx, d_tx, g_mask, d_mask


def build_offsets_optimizer(cfg: TrainConfig, spec: offs_lib.OffsetsSpec,
                            offsets: Params,
                            weight_parts: Tuple[str, ...]) -> Adam:
    """The offsets' optimizer: plain Adam at ``g_lr`` with the config's
    betas and eps, without G's lazy-regularization scaling, on the leaves
    that are both trainable under ``spec`` and named by ``weight_parts``."""
    trainable = tree_to_flat_tensors(offs_lib.trainable_mask(spec, offsets))
    parts = tree_to_flat_tensors(masks_lib.offsets_mask(offsets, weight_parts))
    mask = {k: trainable[k] and parts[k] for k in trainable}
    return dataclasses.replace(
        Adam(cfg.g_lr, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps),
        mask=tuple(sorted(mask.items())))


def init_offsets_state(state: "TrainState", offsets: Params,
                       offsets_tx: Adam) -> "TrainState":
    """Adds the offsets, a copy as their EMA, and their optimizer state."""
    state.offsets = offsets
    state.offsets_ema = sg2.tree_map(torch.clone, offsets)
    state.offsets_opt_state = offsets_tx.init(offsets)
    return state


def init_train_state(cfg: TrainConfig, g_params: Params, d_params: Params,
                     g_tx: Adam, d_tx: Adam) -> TrainState:
    device = next(iter(tree_to_flat_tensors(g_params).values())).device
    return TrainState(
        g_params=g_params,
        d_params=d_params,
        g_ema=sg2.tree_map(torch.clone, g_params),
        g_opt_state=g_tx.init(g_params),
        d_opt_state=d_tx.init(d_params),
        pl_mean=torch.zeros((), device=device),
        ada_p=torch.zeros((), device=device),
        cur_nimg=0)


def _ema_beta(cfg: TrainConfig, cur_nimg: int) -> float:
    ema_nimg = cfg.ema_kimg * 1000.0
    if cfg.ema_rampup is not None:
        ema_nimg = min(ema_nimg, cur_nimg * cfg.ema_rampup)
    return 0.5 ** (cfg.batch_size / max(ema_nimg, 1e-8))


@torch.no_grad()
def ema_update(g_params: Params, g_ema: Params, cur_nimg: int,
               cfg: TrainConfig) -> Params:
    """G_ema lerp in place; buffers copied outright."""
    beta = _ema_beta(cfg, cur_nimg)
    params = tree_to_flat_tensors(g_params)
    for k, e in tree_to_flat_tensors(g_ema).items():
        p = params[k]
        if masks_lib.is_buffer(tuple(k.split("."))):
            e.copy_(p)
        else:
            e.copy_(p + beta * (e - p))
    return g_ema


@torch.no_grad()
def _offsets_ema_update(state: TrainState, cfg: TrainConfig):
    """The offsets EMA in place: every leaf, frozen or not, lerped with
    G_ema's beta at the new ``cur_nimg``."""
    beta = _ema_beta(cfg, state.cur_nimg)
    params = tree_to_flat_tensors(state.offsets)
    for k, e in tree_to_flat_tensors(state.offsets_ema).items():
        p = params[k]
        e.copy_(p + beta * (e - p))


def _prefixed(prefix: str, tree: Dict[str, torch.Tensor]):
    return {prefix + k: v for k, v in tree.items()}


def _unprefixed(prefix: str, tree: Dict[str, torch.Tensor]):
    return {k[len(prefix):]: v for k, v in tree.items() if k.startswith(prefix)}


@torch.no_grad()
def _update_w_avg(g_cfg: sg2.GeneratorConfig, g_params: Params,
                  metrics: Dict[str, torch.Tensor]):
    """The functional w_avg update (networks.py:824-827), in place."""
    mean_w = metrics.pop("aux/mean_w", None)
    if g_cfg.mapping.w_avg_beta is not None:
        w_avg = g_params["mapping"]["w_avg"]
        w_avg.copy_(mean_w + g_cfg.mapping.w_avg_beta * (w_avg - mean_w))


def _round_shard(mesh, n: int, rounds: int, layout: int):
    """The shard of one round's chunk of a global batch of ``n`` cut into
    ``rounds``, whose rows lie in ``layout`` blocks (None without a
    sharded mesh)."""
    if mesh is None or not mesh.sharded:
        return None
    return mesh.batch_shard(n // rounds, layout // rounds)


def _sharded(shard, key, *xs):
    """The round's key and global tensors as the shard's rank sees them
    (unchanged without a shard)."""
    if shard is None:
        return (key,) + xs
    return (shard.key(key),) + tuple(shard.take(x) for x in xs)


def make_phase_steps(cfg: TrainConfig, g_cfg: sg2.GeneratorConfig,
                     d_cfg: sg2.DiscriminatorConfig, g_tx: Adam, d_tx: Adam,
                     augment_fn: gan_loss.AugmentFn = None,
                     offsets_spec: Optional[offs_lib.OffsetsSpec] = None,
                     offsets_tx: Optional[Adam] = None,
                     reg_g_cfg: Optional[sg2.GeneratorConfig] = None,
                     reg_d_cfg: Optional[sg2.DiscriminatorConfig] = None,
                     extra_hooks=None, d_constraint=None):
    """The five phase steps: (g_main, g_reg, d_main, d_reg, gd_main), each
    ``step(state, ...) -> (state, metrics)``.  ``reg_g_cfg`` / ``reg_d_cfg``
    override the model configs of the reg phases only (the path-length
    phase needs ``pallas_level=False``: the fused level is differentiable
    once).  With ``offsets_spec`` every G forward runs under the hooks of
    ``state.offsets``, and with ``offsets_tx`` the G phases train the
    offsets' trainable leaves too.  ``extra_hooks`` are merged after the
    offsets hooks on every G forward and ``d_constraint`` goes to every D
    call: with ``parallel.spatial``'s, the phases run spatially sharded (see
    the module docstring)."""
    lcfg = cfg.loss
    reg_g_cfg = reg_g_cfg or g_cfg
    reg_d_cfg = reg_d_cfg or d_cfg
    main_rounds, g_reg_rounds, d_reg_rounds = _rounds(cfg)
    layout = data_rounds(cfg)

    def make_hooks(offsets):
        hooks = (None if offsets_spec is None
                 else offs_lib.make_hooks(offsets_spec, offsets))
        return (spatial_lib.merge_hooks(hooks, extra_hooks) if extra_hooks
                else hooks)

    def g_leaves(state: TrainState):
        """G's trainable leaves ("G/"), and the offsets' ("O/") when they
        train."""
        leaves = _prefixed("G/", g_tx.trainable(state.g_params))
        if offsets_tx is not None:
            leaves.update(_prefixed("O/", offsets_tx.trainable(state.offsets)))
        return leaves

    def g_update_(state: TrainState, grads):
        """G's Adam step, then the offsets' on their own optimizer."""
        g_tx.update_(_unprefixed("G/", grads), state.g_opt_state,
                     state.g_params)
        if offsets_tx is not None:
            offsets_tx.update_(_unprefixed("O/", grads),
                               state.offsets_opt_state, state.offsets)

    def g_main_step(state: TrainState, z, c, key, mesh=None):
        shard = _round_shard(mesh, z.shape[0], main_rounds, layout)

        def run_round(r, k):
            k, zr, cr = _sharded(shard, k, _chunk(z, main_rounds, r),
                                 _chunk(c, main_rounds, r))
            return gan_loss.g_main_loss(
                lcfg, g_cfg, d_cfg, state.g_params, state.d_params, zr, cr, k,
                augment_fn=augment_fn, ada_p=state.ada_p,
                hooks=make_hooks(state.offsets), shard=shard,
                d_constraint=d_constraint)

        metrics, grads = _accum(run_round, main_rounds, key, g_leaves(state),
                                mesh)
        with trace_scope("step.update"):
            g_update_(state, _scrub(grads))
            _update_w_avg(g_cfg, state.g_params, metrics)
            # Freed inside the span: releasing the gradients is host time.
            del grads
        return state, metrics

    def g_reg_step(state: TrainState, z, c, key, mesh=None):
        gain = float(cfg.g_reg_interval or 1)
        # The PL batch is the first 1/pl_batch_shrink of each round's
        # global chunk: one block a rank, or the whole of it on every rank
        # where it does not split evenly (the averages over the ranks are
        # then those of the one batch).
        shard = None
        if mesh is not None and mesh.sharded:
            n = z.shape[0] // g_reg_rounds // lcfg.pl_batch_shrink
            shard = (mesh.batch_shard(n) if n % mesh.world_size == 0
                     else mesh_lib.BatchShard(mesh, range(n), n))

        def run_round(r, k):
            loss, metrics = gan_loss.g_pl_loss(
                lcfg, reg_g_cfg, state.g_params, _chunk(z, g_reg_rounds, r),
                _chunk(c, g_reg_rounds, r), _sharded(shard, k)[0],
                state.pl_mean, hooks=make_hooks(state.offsets), shard=shard)
            return loss * gain, metrics

        metrics, grads = _accum(run_round, g_reg_rounds, key, g_leaves(state),
                                mesh)
        with trace_scope("step.update"):
            g_update_(state, _scrub(grads))
            del grads
        state.pl_mean = metrics.pop("aux/pl_mean")
        return state, metrics

    def gd_main_step(state: TrainState, real_img, real_c, z, gen_c, key,
                     mesh=None):
        """Simultaneous Gmain+Dmain over one shared G forward."""
        leaves = g_leaves(state)
        leaves.update(_prefixed("D/", d_tx.trainable(state.d_params)))
        shard = _round_shard(mesh, z.shape[0], main_rounds, layout)

        def run_round(r, k):
            k, zr, cr = _sharded(shard, k, _chunk(z, main_rounds, r),
                                 _chunk(gen_c, main_rounds, r))
            return gan_loss.gd_main_loss(
                lcfg, g_cfg, d_cfg, state.g_params, state.d_params,
                _chunk(real_img, main_rounds, r),
                _chunk(real_c, main_rounds, r), zr, cr, k,
                augment_fn=augment_fn, ada_p=state.ada_p,
                hooks=make_hooks(state.offsets),
                ga_threshold=cfg.ga_threshold,
                ga_mutation_rate=cfg.ga_mutation_rate, shard=shard,
                d_constraint=d_constraint)

        metrics, grads = _accum(run_round, main_rounds, key, leaves, mesh)
        with trace_scope("step.update"):
            grads = _scrub(grads)
            g_update_(state, grads)
            d_tx.update_(_unprefixed("D/", grads), state.d_opt_state,
                         state.d_params)
            _update_w_avg(g_cfg, state.g_params, metrics)
            del grads
        return state, metrics

    def d_main_step(state: TrainState, real_img, real_c, z, gen_c, key,
                    mesh=None):
        leaves = d_tx.trainable(state.d_params)
        shard = _round_shard(mesh, z.shape[0], main_rounds, layout)

        def run_round(r, k):
            k, zr, cr = _sharded(shard, k, _chunk(z, main_rounds, r),
                                 _chunk(gen_c, main_rounds, r))
            return gan_loss.d_main_loss(
                lcfg, g_cfg, d_cfg, state.g_params, state.d_params,
                _chunk(real_img, main_rounds, r),
                _chunk(real_c, main_rounds, r), zr, cr, k,
                augment_fn=augment_fn, ada_p=state.ada_p,
                hooks=make_hooks(state.offsets),
                ga_threshold=cfg.ga_threshold,
                ga_mutation_rate=cfg.ga_mutation_rate, shard=shard,
                d_constraint=d_constraint)

        metrics, grads = _accum(run_round, main_rounds, key, leaves, mesh)
        with trace_scope("step.update"):
            d_tx.update_(_scrub(grads), state.d_opt_state, state.d_params)
            del grads
        return state, metrics

    def d_reg_step(state: TrainState, real_img, real_c, key, mesh=None):
        gain = float(cfg.d_reg_interval or 1)
        leaves = d_tx.trainable(state.d_params)
        shard = (None if mesh is None else _round_shard(
            mesh, real_img.shape[0] * mesh.world_size, d_reg_rounds, layout))

        def run_round(r, k):
            loss, metrics = gan_loss.d_r1_loss(
                lcfg, reg_d_cfg, state.d_params,
                _chunk(real_img, d_reg_rounds, r),
                _chunk(real_c, d_reg_rounds, r), _sharded(shard, k)[0],
                augment_fn=augment_fn, ada_p=state.ada_p, shard=shard,
                d_constraint=d_constraint)
            return loss * gain, metrics

        metrics, grads = _accum(run_round, d_reg_rounds, key, leaves, mesh)
        with trace_scope("step.update"):
            d_tx.update_(_scrub(grads), state.d_opt_state, state.d_params)
            del grads
        return state, metrics

    return g_main_step, g_reg_step, d_main_step, d_reg_step, gd_main_step


def make_fused_step(cfg: TrainConfig, g_cfg: sg2.GeneratorConfig,
                    d_cfg: sg2.DiscriminatorConfig, g_tx: Adam, d_tx: Adam,
                    augment_fn: gan_loss.AugmentFn = None,
                    do_g_reg: bool = True, do_d_reg: bool = True,
                    offsets_spec=None, offsets_tx=None, reg_g_cfg=None,
                    reg_d_cfg=None, extra_hooks=None, d_constraint=None):
    """One batch = Gmain [+Greg] + Dmain [+Dreg] + EMA + nimg bump, as
    ``step(state, real_img, real_c, z, gen_c, key, mesh=None) -> (state,
    metrics)``; ``cur_nimg`` advances by ``cfg.batch_size``.  With a
    sharded ``mesh`` (``parallel.mesh.shard_train_step``) the step is one
    rank's part of the data-parallel step; with ``parallel.spatial``'s
    ``extra_hooks`` / ``d_constraint`` it is one rank's part of the
    spatially sharded step, called without a mesh (see the module
    docstring)."""
    g_main, g_reg, d_main, d_reg, gd_main = make_phase_steps(
        cfg, g_cfg, d_cfg, g_tx, d_tx, augment_fn, offsets_spec=offsets_spec,
        offsets_tx=offsets_tx, reg_g_cfg=reg_g_cfg, reg_d_cfg=reg_d_cfg,
        extra_hooks=extra_hooks, d_constraint=d_constraint)

    spatial = spatial_lib.is_spatial(extra_hooks, d_constraint)

    def step(state: TrainState, real_img, real_c, z, gen_c, key, mesh=None):
        if spatial and mesh is not None and mesh.sharded:
            raise ValueError(
                "a spatially sharded step holds the whole batch on every "
                "rank: call it without a mesh (the hooks carry theirs)")
        if (mesh is not None and mesh.sharded
                and real_img.shape[0] * mesh.world_size != z.shape[0]):
            raise ValueError(
                f"rank {mesh.rank}: {real_img.shape[0]} real images, but "
                f"z holds the global batch of {z.shape[0]} over "
                f"{mesh.world_size} ranks: pass the rank's share of the "
                f"images (shard_batch) and the global z")
        keys = key.split(4)
        metrics: Dict[str, torch.Tensor] = {}
        if cfg.simultaneous_main:
            with trace_scope("step.gd_main", device=True):
                state, m = gd_main(state, real_img, real_c, z, gen_c, keys[0],
                                   mesh)
            metrics.update(m)
            if do_g_reg and cfg.g_reg_interval is not None:
                with trace_scope("step.g_reg", device=True):
                    state, m = g_reg(state, z, gen_c, keys[1], mesh)
                metrics.update(m)
        else:
            with trace_scope("step.g_main", device=True):
                state, m = g_main(state, z, gen_c, keys[0], mesh)
            metrics.update(m)
            if do_g_reg and cfg.g_reg_interval is not None:
                with trace_scope("step.g_reg", device=True):
                    state, m = g_reg(state, z, gen_c, keys[1], mesh)
                metrics.update(m)
            with trace_scope("step.d_main", device=True):
                state, m = d_main(state, real_img, real_c, z, gen_c, keys[2],
                                  mesh)
            metrics.update(m)
        if do_d_reg and cfg.d_reg_interval is not None:
            with trace_scope("step.d_reg", device=True):
                state, m = d_reg(state, real_img, real_c, keys[3], mesh)
            metrics.update(m)
        state.cur_nimg += cfg.batch_size
        with trace_scope("step.ema"):
            ema_update(state.g_params, state.g_ema, state.cur_nimg, cfg)
            if state.offsets is not None and state.offsets_ema is not None:
                _offsets_ema_update(state, cfg)
        return state, metrics

    return step


def ada_update(cfg: TrainConfig, ada_p, real_signs_mean: float) -> float:
    """ADA p adjustment, run on the host every ada_interval batches."""
    adjust = np.sign(real_signs_mean - cfg.ada_target) * (
        cfg.batch_size * cfg.ada_interval) / (cfg.ada_kimg * 1000)
    return float(np.clip(float(ada_p) + adjust, 0.0, 1.0))
