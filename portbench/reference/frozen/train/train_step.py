"""The ADA training step (frozen copy of the port's train/train_step.py,
cut to what the benchmark's reference runs: one process, the simultaneous
Gmain+Dmain over one G forward, lazy regularization, gradient-accumulation
rounds, EMA and the ``w_avg`` / ``pl_mean`` updates).

* The caller schedules the reg phases every ``*_reg_interval`` batches by
  picking one of the fused step variants
  (``make_fused_step(do_g_reg=..., do_d_reg=...)``).
* The optimizers are optax's ``adam`` with the lazy-regularization scaling
  (lr * mb_ratio, betas ** mb_ratio), masked so that frozen leaves get no
  update and no state (:class:`Adam`).
* Rounds AVERAGE the per-round gradients and metrics.
* With an offsets spec and optimizer (domain adaptation: Affine+), every G
  phase differentiates G's trainable leaves and the trainable offsets
  together under the offsets' hooks, and the offsets take their own masked
  Adam step after G's; the offsets keep an EMA of their own.

The steps update the state's tensors in place (parameters, EMA, optimizer
moments) and return the same state object.  Gradients are taken by
flagging the trainable leaves ``requires_grad`` for the length of a phase.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import stylegan2 as sg2
from ..params import offsets as offs_lib
from ..utils.checkpoint import tree_to_flat_tensors
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
    batch_size: int = 32                  # the batch (for the EMA rate)
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


def _accum(run_round: Callable, rounds: int, key,
           leaves: Dict[str, torch.Tensor]):
    """Average the metrics and the gradients (with respect to ``leaves``)
    of ``run_round(r, key_r) -> (loss, metrics)`` over ``rounds``
    sequential chunks; with one round the caller's key passes through.
    Returns (metrics, grads)."""
    for t in leaves.values():
        t.requires_grad_(True)
        t.grad = None
    acc: Dict[str, torch.Tensor] = {}
    try:
        for r in range(max(rounds, 1)):
            loss, metrics = run_round(r, key if rounds <= 1 else key.fold_in(r))
            loss.backward()
            del loss
            for k, v in metrics.items():
                acc[k] = v if k not in acc else acc[k] + v
        n = float(max(rounds, 1))
        grads = {k: (t.grad / n if t.grad is not None
                     else torch.zeros_like(t)) for k, t in leaves.items()}
    finally:
        for t in leaves.values():
            t.grad = None
            t.requires_grad_(False)
    metrics = {k: v / n for k, v in acc.items()}
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


def make_phase_steps(cfg: TrainConfig, g_cfg: sg2.GeneratorConfig,
                     d_cfg: sg2.DiscriminatorConfig, g_tx: Adam, d_tx: Adam,
                     augment_fn: gan_loss.AugmentFn = None,
                     offsets_spec: Optional[offs_lib.OffsetsSpec] = None,
                     offsets_tx: Optional[Adam] = None,
                     reg_g_cfg: Optional[sg2.GeneratorConfig] = None,
                     reg_d_cfg: Optional[sg2.DiscriminatorConfig] = None):
    """The three phase steps: (g_reg, d_reg, gd_main), each ``step(state,
    ...) -> (state, metrics)``.  ``reg_g_cfg`` / ``reg_d_cfg`` override the
    model configs of the reg phases only.  With ``offsets_spec`` every G
    forward runs under the hooks of ``state.offsets``, and with
    ``offsets_tx`` the G phases train the offsets' trainable leaves too."""
    lcfg = cfg.loss
    reg_g_cfg = reg_g_cfg or g_cfg
    reg_d_cfg = reg_d_cfg or d_cfg
    main_rounds, g_reg_rounds, d_reg_rounds = _rounds(cfg)

    def make_hooks(offsets):
        return (None if offsets_spec is None
                else offs_lib.make_hooks(offsets_spec, offsets))

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

    def g_reg_step(state: TrainState, z, key):
        gain = float(cfg.g_reg_interval or 1)

        def run_round(r, k):
            loss, metrics = gan_loss.g_pl_loss(
                lcfg, reg_g_cfg, state.g_params, _chunk(z, g_reg_rounds, r),
                k, state.pl_mean, hooks=make_hooks(state.offsets))
            return loss * gain, metrics

        metrics, grads = _accum(run_round, g_reg_rounds, key, g_leaves(state))
        g_update_(state, _scrub(grads))
        state.pl_mean = metrics.pop("aux/pl_mean")
        return state, metrics

    def gd_main_step(state: TrainState, real_img, z, key):
        """Simultaneous Gmain+Dmain over one shared G forward."""
        leaves = g_leaves(state)
        leaves.update(_prefixed("D/", d_tx.trainable(state.d_params)))

        def run_round(r, k):
            return gan_loss.gd_main_loss(
                lcfg, g_cfg, d_cfg, state.g_params, state.d_params,
                _chunk(real_img, main_rounds, r), _chunk(z, main_rounds, r),
                k, augment_fn=augment_fn, ada_p=state.ada_p,
                hooks=make_hooks(state.offsets))

        metrics, grads = _accum(run_round, main_rounds, key, leaves)
        grads = _scrub(grads)
        g_update_(state, grads)
        d_tx.update_(_unprefixed("D/", grads), state.d_opt_state,
                     state.d_params)
        _update_w_avg(g_cfg, state.g_params, metrics)
        return state, metrics

    def d_reg_step(state: TrainState, real_img, key):
        gain = float(cfg.d_reg_interval or 1)
        leaves = d_tx.trainable(state.d_params)

        def run_round(r, k):
            loss, metrics = gan_loss.d_r1_loss(
                lcfg, reg_d_cfg, state.d_params,
                _chunk(real_img, d_reg_rounds, r), k,
                augment_fn=augment_fn, ada_p=state.ada_p)
            return loss * gain, metrics

        metrics, grads = _accum(run_round, d_reg_rounds, key, leaves)
        d_tx.update_(_scrub(grads), state.d_opt_state, state.d_params)
        return state, metrics

    return g_reg_step, d_reg_step, gd_main_step


def make_fused_step(cfg: TrainConfig, g_cfg: sg2.GeneratorConfig,
                    d_cfg: sg2.DiscriminatorConfig, g_tx: Adam, d_tx: Adam,
                    augment_fn: gan_loss.AugmentFn = None,
                    do_g_reg: bool = True, do_d_reg: bool = True,
                    offsets_spec=None, offsets_tx=None, reg_g_cfg=None,
                    reg_d_cfg=None):
    """One batch = Gmain+Dmain [+Greg] [+Dreg] + EMA + nimg bump, as
    ``step(state, real_img, real_c, z, gen_c, key) -> (state, metrics)``
    (the labels ``real_c`` and ``gen_c`` are None: the reference's networks
    are unconditional); ``cur_nimg`` advances by ``cfg.batch_size``."""
    g_reg, d_reg, gd_main = make_phase_steps(
        cfg, g_cfg, d_cfg, g_tx, d_tx, augment_fn, offsets_spec=offsets_spec,
        offsets_tx=offsets_tx, reg_g_cfg=reg_g_cfg, reg_d_cfg=reg_d_cfg)

    def step(state: TrainState, real_img, real_c, z, gen_c, key):
        keys = key.split(4)
        metrics: Dict[str, torch.Tensor] = {}
        state, m = gd_main(state, real_img, z, keys[0])
        metrics.update(m)
        if do_g_reg and cfg.g_reg_interval is not None:
            state, m = g_reg(state, z, keys[1])
            metrics.update(m)
        if do_d_reg and cfg.d_reg_interval is not None:
            state, m = d_reg(state, real_img, keys[3])
            metrics.update(m)
        state.cur_nimg += cfg.batch_size
        ema_update(state.g_params, state.g_ema, state.cur_nimg, cfg)
        if state.offsets is not None and state.offsets_ema is not None:
            _offsets_ema_update(state, cfg)
        return state, metrics

    return step

