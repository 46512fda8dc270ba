"""The one-shot CLIP-guided adaptation trainer StyleGAN-NADA
(``td_single``): frozen copy of the port's train/adaptation.py, cut to
that trainer (the port's also runs MindTheGap, JoJoGAN and DiFa) and to
the options that the benchmark's reference sets.

A trainer holds a frozen source generator, frozen CLIP towers and the
domain's text embeddings, and trains an offsets tree (params/offsets.py)
with Adam on the configured losses.

Each step draws, from one key of the trainer's draw tree, two batches of
``z``, the style-mixing gate and (from the same key as the noise) the
crossover layer.  With a per-sample-only spec (style / w-space offsets) the
frozen and the trainable images come from one synthesis pass over the
doubled batch, the offsets gated to its second half; otherwise from two
passes on the same noise.  Both CLIP passes run as one batch per tower.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..clip import model as clip_model
from ..models import stylegan2 as sg2
from ..params import offsets as offs_lib
from ..utils import checkpoint as ckpt
from . import adapt_losses as al
from .train_step import Adam

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AdaptationConfig:
    trainer: str = "td_single"
    batch_size: int = 4
    lr: float = 0.002
    betas: Tuple[float, float] = (0.9, 0.999)
    mixing_noise: float = 0.9
    parametrization: str = "additive"     # offsets grammar
    visual_encoders: Tuple[str, ...] = ("ViT-B/32",)
    # Compute dtype of the frozen CLIP towers: "bfloat16" (LayerNorms,
    # softmax and the embeddings stay fp32) or "float32".
    clip_dtype: str = "bfloat16"
    loss: al.DirectLossConfig = dataclasses.field(
        default_factory=al.DirectLossConfig)


def _frozen(tree: Params) -> Params:
    """The tree's tensors, detached: they never require grad."""
    return {k: _frozen(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


class AdaptationTrainer:
    """Trains offsets against a frozen generator and frozen CLIP towers.

    clip_encoders: {name: (CLIPConfig, params)} for each visual encoder.
    domain_embeddings: {name: {"src": [1, T, D], "trg": [1, T, D]}}, text
      embeddings over T templates (the direction loss averages them).
    rng: the trainer's draw tree (utils/rng.py ``Rng``); split once for the
      offsets' random factors, then once a step.
    offsets: the offsets tree to start from (copied to ``device``).
    """

    def __init__(self, cfg: AdaptationConfig, g_cfg: sg2.GeneratorConfig,
                 g_params: Params,
                 clip_encoders: Dict[str, Tuple[clip_model.CLIPConfig,
                                                Params]],
                 rng, domain_embeddings: Dict[str, Dict[str, torch.Tensor]],
                 device="cuda", offsets: Optional[Params] = None):
        if cfg.trainer != "td_single":
            raise ValueError(f"the reference runs td_single, not "
                             f"{cfg.trainer!r}")
        self.cfg, self.g_cfg = cfg, g_cfg
        self.device = torch.device(device)
        self.g_params = _frozen(g_params)
        self.clip_encoders = {n: (c, _frozen(p))
                              for n, (c, p) in clip_encoders.items()}
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
        self.domain_embeddings = {n: _frozen(e) for n, e in
                                  domain_embeddings.items()}

    # ------------------------------------------------------------------

    def _encode(self, name, images, return_hidden=()):
        ccfg, cparams = self.clip_encoders[name]
        img = torch.clamp(images * 127.5 + 128, 0, 255)
        dtype = torch.bfloat16 if self.cfg.clip_dtype == "bfloat16" else None
        return clip_model.encode_image(ccfg, cparams, img,
                                       return_hidden=return_hidden,
                                       dtype=dtype)

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
        """The step's losses with 'total' at ``offsets`` on the draws of
        ``key``: z, z2, the mixing gate and the noise key."""
        cfg, g_cfg = self.cfg, self.g_cfg
        k_z, k_z2, k_mix, k_noise = key.split(4)
        z = k_z.normal((cfg.batch_size, g_cfg.z_dim), self.device)
        z2 = k_z2.normal((cfg.batch_size, g_cfg.z_dim), self.device)
        use_mix = k_mix.uniform((), self.device) < cfg.mixing_noise
        frozen_img, trainable_img = self._images(offsets, z, z2, use_mix,
                                                 k_noise)
        clip_data = {}
        for name in cfg.visual_encoders:
            # One tower pass over [trainable; frozen]: the ViT treats the
            # samples independently, so this equals two passes.
            both, _ = self._encode(name, torch.cat([trainable_img,
                                                    frozen_img]))
            trg_enc, src_enc = both.chunk(2)
            emb = self.domain_embeddings[name]
            clip_data[name] = {"trg_encoded": trg_enc, "src_encoded": src_enc,
                               "trg_domain_emb": emb["trg"],
                               "src_domain_emb": emb["src"]}
        return al.direct_loss(cfg.loss, {"clip_data": clip_data,
                                         "offsets": offsets})

    def _loss_and_grads(self, key):
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

    def train_step_async(self) -> Dict[str, torch.Tensor]:
        """One adaptation step; the losses stay on the device."""
        self.rng, k_step, _k_auto = self.rng.split(3)
        losses, grads = self._loss_and_grads(k_step)
        self.tx.update_(grads, self.opt_state, self.offsets)
        return losses
