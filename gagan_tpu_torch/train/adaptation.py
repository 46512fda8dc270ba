"""One-shot CLIP-guided domain adaptation: StyleGAN-NADA's ``td_single``
trainer (port of gagan_tpu/train/adaptation.py).

A trainer holds a frozen source generator, frozen CLIP towers and the
domain's text embeddings, and trains an offsets tree (params/offsets.py)
with Adam on the CLIP direction loss and the offsets' regularizers.  The
frozen trees never require grad, so the fused modconv level's backward
computes dx and d(styles) but no weight gradient for them.

Each step draws, from one key of the trainer's draw tree, two batches of
``z``, the style-mixing gate and (from the same key as the noise) the
crossover layer.  With a per-sample-only spec (style / w-space offsets) the
frozen and the trainable images come from one synthesis pass over the
doubled batch, the offsets gated to its second half; otherwise from two
passes on the same noise.  Both CLIP passes run as one batch per tower.
Losses stay on the device: ``train`` reads them on the host only on the
log cadence.

With ``auto_layer_iters > 0`` each step first runs the adaptive layer
probe (train/auto_layers.py) on its own key and trains only the offsets of
the top ``auto_layer_k`` layers, as the JAX trainer does.

The JAX module's other trainers (``im2im_single``, ``im2im_JoJo``,
``im2im_difa``) and the DiFa SCC loss inside the trainer are not ported yet
and raise ``NotImplementedError`` naming the ROADMAP item they wait for.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..clip import model as clip_model
from ..models import stylegan2 as sg2
from ..params import offsets as offs_lib
from ..utils import checkpoint as ckpt
from ..utils.config import to_dict
from . import adapt_losses as al
from . import auto_layers
from .train_step import Adam

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AdaptationConfig:
    trainer: str = "td_single"       # td_single | im2im_single | im2im_JoJo | im2im_difa
    batch_size: int = 4
    iter_num: int = 301
    lr: float = 0.002
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.0
    lr_warmup_steps: int = 0
    mixing_noise: float = 0.9
    source_class: str = "Photo"
    target_class: str = ""
    parametrization: str = "additive"     # offsets grammar
    visual_encoders: Tuple[str, ...] = ("ViT-B/32",)
    clip_layer: int = 8                   # DiFa token layer
    # JoJoGAN:
    alpha: float = 0.0
    preserve_color: bool = False
    # DiFa:
    use_difa_tokens: bool = True
    # Adaptive layer freezing; 0 iters disables the probe.
    auto_layer_iters: int = 0
    auto_layer_batch: int = 8
    auto_layer_k: int = 10
    # Compute dtype of the frozen CLIP towers: "bfloat16" (LayerNorms,
    # softmax and the embeddings stay fp32) or "float32".
    clip_dtype: str = "bfloat16"
    loss: al.DirectLossConfig = dataclasses.field(
        default_factory=al.DirectLossConfig)
    log_every: int = 10
    checkpoint_every: int = 100


# The trainers of the JAX module that wait for other modules of the port.
_UNPORTED_TRAINERS = {
    "im2im_single": "the projector and VGG16-LPIPS, ROADMAP items 11b-13",
    "im2im_JoJo": "the projector, ROADMAP items 11b-12",
    "im2im_difa": "the e4e encoder and the projector, ROADMAP items 11b-12",
}


def _to_host(losses: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The losses as floats, in one device-to-host copy."""
    values = torch.stack([v.float() for v in losses.values()]).tolist()
    return dict(zip(losses, values))


def _frozen(tree: Params) -> Params:
    """The tree's tensors, detached: they never require grad."""
    return {k: _frozen(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


class AdaptationTrainer:
    """Trains offsets against a frozen generator and frozen CLIP towers.

    clip_encoders: {name: (CLIPConfig, params)} for each visual encoder.
    domain_embeddings: {name: {"src": [1, D] or [1, T, D], "trg": ...}},
      text embeddings over T templates (the direction loss averages them).
    rng: the trainer's draw tree (utils/rng.py ``Rng``, or any object with
      its methods, e.g. one backed by ``jax.random`` in tests); split once
      for the offsets' random factors, then once a step.
    offsets: an initial offsets tree to start from instead of
      ``init_offsets`` (copied to ``device``).
    """

    def __init__(self, cfg: AdaptationConfig, g_cfg: sg2.GeneratorConfig,
                 g_params: Params,
                 clip_encoders: Dict[str, Tuple[clip_model.CLIPConfig,
                                                Params]],
                 rng, domain_embeddings: Dict[str, Dict[str, torch.Tensor]],
                 device="cuda", offsets: Optional[Params] = None):
        self.check_config(cfg)
        self.cfg, self.g_cfg = cfg, g_cfg
        self.device = torch.device(device)
        self.g_params = _frozen(g_params)
        self.clip_encoders = {n: (c, _frozen(p))
                              for n, (c, p) in clip_encoders.items()}
        self.domain_embeddings = {n: _frozen(e)
                                  for n, e in domain_embeddings.items()}
        self.spec = offs_lib.OffsetsSpec.from_string(cfg.parametrization)
        self.rng, r_off = rng.split(2)
        if offsets is None:
            offsets = offs_lib.init_offsets(r_off, g_cfg.synthesis, self.spec,
                                            self.device)
        self.offsets = sg2.tree_map(
            lambda t: t.detach().to(self.device, torch.float32).clone(),
            offsets)
        mask = offs_lib.trainable_mask(self.spec, self.offsets)
        self.tx = Adam(cfg.lr, cfg.betas[0], cfg.betas[1], 1e-8,
                       mask=tuple(sorted(
                           ckpt.tree_to_flat_tensors(mask).items())))
        self.opt_state = self.tx.init(self.offsets)
        self.current_step = 0
        self._auto_score_fn = None

    @staticmethod
    def check_config(cfg: AdaptationConfig):
        """Raises for what the port cannot train yet."""
        if cfg.trainer in _UNPORTED_TRAINERS:
            raise NotImplementedError(
                f"trainer {cfg.trainer!r} needs "
                f"{_UNPORTED_TRAINERS[cfg.trainer]}; the port has td_single")
        if cfg.trainer != "td_single":
            raise ValueError(f"unknown trainer {cfg.trainer!r}")
        if cfg.loss.scc is not None:
            raise NotImplementedError(
                "difa_w (the SCC loss) needs the e4e image encoder, not "
                "ported yet (ROADMAP item 12)")

    # ------------------------------------------------------------------

    def _encode(self, name, images):
        ccfg, cparams = self.clip_encoders[name]
        img = torch.clamp(images * 127.5 + 128, 0, 255)
        dtype = torch.bfloat16 if self.cfg.clip_dtype == "bfloat16" else None
        return clip_model.encode_image(ccfg, cparams, img, dtype=dtype)[0]

    def _mixed_ws(self, z, z2, use_mix, noise_key):
        """With probability ``mixing_noise`` (``use_mix``), style mixing of
        the two z's at a crossover layer drawn from ``noise_key``."""
        mcfg, mparams = self.g_cfg.mapping, self.g_params["mapping"]
        ws1 = sg2.mapping_apply(mcfg, mparams, z)
        ws2 = sg2.mapping_apply(mcfg, mparams, z2)
        num_ws = self.g_cfg.num_ws
        inject = noise_key.randint((), 1, num_ws, self.device)
        layer_idx = torch.arange(num_ws, device=self.device)[None, :, None]
        ws_mixed = torch.where(layer_idx < inject, ws1, ws2)
        return torch.where(use_mix, ws_mixed, ws1)

    def _synthesis(self, ws, noise_key, hooks):
        return sg2.synthesis_apply(
            self.g_cfg.synthesis, self.g_params["synthesis"], ws,
            noise_mode="random", generator=noise_key.fold_in(1), hooks=hooks)

    def _images(self, offsets, z, z2, use_mix, noise_key):
        """(frozen images without a graph, trainable images)."""
        batch = z.shape[0]
        ws = self._mixed_ws(z, z2, use_mix, noise_key)
        if self.spec.per_sample_only:
            # One pass over [ws; ws], the offsets on the second half; the
            # halves draw independent layer noise.
            sel = torch.arange(2 * batch, device=self.device) >= batch
            both = self._synthesis(
                torch.cat([ws, ws]), noise_key,
                offs_lib.make_hooks(self.spec, offsets, batch_select=sel))
            return both[:batch].detach(), both[batch:]
        with torch.no_grad():
            frozen = self._synthesis(ws, noise_key, None)
        return frozen, self._synthesis(
            ws, noise_key, offs_lib.make_hooks(self.spec, offsets))

    def losses(self, offsets: Params, key) -> Dict[str, torch.Tensor]:
        """The step's losses (with 'total') at ``offsets`` on the draws of
        ``key``: z, z2, the mixing gate and the noise key."""
        cfg = self.cfg
        k_z, k_z2, k_mix, k_noise = key.split(4)
        z = k_z.normal((cfg.batch_size, self.g_cfg.z_dim), self.device)
        z2 = k_z2.normal((cfg.batch_size, self.g_cfg.z_dim), self.device)
        use_mix = k_mix.uniform((), self.device) < cfg.mixing_noise
        frozen_img, trainable_img = self._images(offsets, z, z2, use_mix,
                                                 k_noise)
        clip_data = {}
        for name in cfg.visual_encoders:
            # One tower pass over [trainable; frozen]: the ViT treats the
            # samples independently, so this equals two passes.
            trg_enc, src_enc = self._encode(
                name, torch.cat([trainable_img, frozen_img])).chunk(2)
            emb = self.domain_embeddings[name]
            clip_data[name] = {"trg_encoded": trg_enc, "src_encoded": src_enc,
                               "trg_domain_emb": emb["trg"],
                               "src_domain_emb": emb["src"]}
        losses, _ = al.direct_loss(cfg.loss, {"clip_data": clip_data,
                                              "rec_data": {},
                                              "offsets": offsets})
        return losses

    def loss_and_grads(self, key):
        """(losses, {dotted key: gradient}) at the current offsets, for the
        trainable leaves only."""
        leaves = self.tx.trainable(self.offsets)
        for t in leaves.values():
            t.requires_grad_(True)
        try:
            losses = self.losses(self.offsets, key)
            grads = torch.autograd.grad(losses["total"], list(leaves.values()),
                                        allow_unused=True)
        finally:
            for t in leaves.values():
                t.requires_grad_(False)
        grads = {k: g if g is not None else torch.zeros_like(t)
                 for (k, t), g in zip(leaves.items(), grads)}
        return {k: v.detach() for k, v in losses.items()}, grads

    def _auto_layer_mask(self, key) -> Dict[str, torch.Tensor]:
        """The step's 0/1 gradient mask by dotted key: the adaptive layer
        probe on the first visual encoder, from ``key``'s latents and
        noise."""
        cfg = self.cfg
        enc = cfg.visual_encoders[0]
        ccfg, cparams = self.clip_encoders[enc]
        if self._auto_score_fn is None:
            self._auto_score_fn = auto_layers.make_layer_score_fn(
                self.g_cfg, ccfg, cfg.auto_layer_iters)
        k_z, k_opt = key.split(2)
        z = k_z.normal((cfg.auto_layer_batch, self.g_cfg.z_dim), self.device)
        scores = self._auto_score_fn(self.g_params, cparams,
                                     self.domain_embeddings[enc]["trg"], z,
                                     k_opt)
        chosen = auto_layers.choose_layers(
            scores, self.g_cfg.synthesis.layer_names(), cfg.auto_layer_k)
        return ckpt.tree_to_flat_tensors(
            auto_layers.layer_grad_mask(self.offsets, chosen))

    def train_step_async(self) -> Dict[str, torch.Tensor]:
        """One adaptation step; the losses stay on the device."""
        cfg = self.cfg
        self.rng, k_step, k_auto = self.rng.split(3)
        losses, grads = self.loss_and_grads(k_step)
        if cfg.auto_layer_iters > 0:
            mask = self._auto_layer_mask(k_auto)
            grads = {k: g * mask[k] for k, g in grads.items()}
        if cfg.weight_decay:
            leaves = self.tx.trainable(self.offsets)
            grads = {k: g + cfg.weight_decay * leaves[k]
                     for k, g in grads.items()}
        lr = cfg.lr
        if cfg.lr_warmup_steps > 0:
            lr = cfg.lr * min(self.opt_state.count, cfg.lr_warmup_steps) \
                / cfg.lr_warmup_steps
        dataclasses.replace(self.tx, lr=lr).update_(grads, self.opt_state,
                                                    self.offsets)
        self.current_step += 1
        return losses

    def train_step(self) -> Dict[str, float]:
        return _to_host(self.train_step_async())

    def save(self, path: str):
        """The offsets as an adaptation checkpoint (generate --s-direction,
        inference.Inferencer)."""
        ckpt.save_adaptation(path, model_type="parametrization",
                             parametrization=self.cfg.parametrization,
                             offsets=self.offsets,
                             sg2_config=to_dict(self.g_cfg))

    def train(self, log_fn: Optional[Callable] = None,
              checkpoint_dir: Optional[str] = None) -> Params:
        """``iter_num`` steps; ``log_fn(step, losses)`` every ``log_every``
        steps (the only host reads of the losses) and an
        ``adaptation-NNNNNN.npz`` every ``checkpoint_every`` steps."""
        for step_idx in range(self.cfg.iter_num):
            losses = self.train_step_async()
            if log_fn is not None and step_idx % self.cfg.log_every == 0:
                log_fn(step_idx, _to_host(losses))
            if checkpoint_dir and (step_idx + 1) % self.cfg.checkpoint_every == 0:
                self.save(os.path.join(checkpoint_dir,
                                       f"adaptation-{step_idx + 1:06d}.npz"))
        return self.offsets

    def synthesize(self, z: torch.Tensor, truncation: float = 1.0):
        """Adapted images of ``z`` (const noise)."""
        with torch.no_grad():
            return sg2.generator_apply(
                self.g_cfg, self.g_params, z, truncation_psi=truncation,
                hooks=offs_lib.make_hooks(self.spec, self.offsets))
