"""One-shot CLIP-guided domain adaptation trainers (port of
gagan_tpu/train/adaptation.py): StyleGAN-NADA (``td_single``), MindTheGap
(``im2im_single``), JoJoGAN (``im2im_JoJo``) and DiFa (``im2im_difa``).

A trainer holds a frozen source generator, frozen CLIP towers and the
domain's embeddings, and trains an offsets tree (params/offsets.py) with
Adam on the configured losses.  The frozen trees never require grad, so the
fused modconv level's backward computes dx and d(styles) but no weight
gradient for them.

Each step draws, from one key of the trainer's draw tree, two batches of
``z``, the style-mixing gate and (from the same key as the noise) the
crossover layer.  With a per-sample-only spec (style / w-space offsets) the
frozen and the trainable images come from one synthesis pass over the
doubled batch, the offsets gated to its second half; otherwise from two
passes on the same noise.  Both CLIP passes run as one batch per tower.
Losses stay on the device: ``train`` reads them on the host only on the
log cadence.

The image-driven trainers start from a style image (uint8 [C, H, W]) and,
for the reconstruction losses, its W+ latents (from the projector or a
file).  Their constants are the CLIP embeddings of the style image ("trg")
and of ``style_image_inverted_A`` ("src", the style image itself when none
is given), and for DiFa the style image's CLIP tokens at ``clip_layer``,
L2-normalised.  ``im2im_single`` and ``im2im_difa`` render the style
latents through the offsets (``inverted_B``, const noise) when the
reconstruction or ``clip_ref`` losses read it; ``im2im_JoJo`` renders the
style latents mixed with the batch's mapped latents at the layers
``id_swap``, and skips the frozen / trainable pair its losses never read.
(The JAX step computes all of them; XLA drops what no loss reads.)
``lpips_rec`` reads the VGG16-LPIPS embeddings of the 256^2 pair.  The
DiFa SCC loss (``loss.scc``, the config's ``difa_w``) encodes both halves
with e4e (inversion/encoders.py) at ``E4E_SIZE``^2, the gradient through
the trainable half only, and keeps its sliding window in ``scc_state``.

With ``auto_layer_iters > 0`` each step first runs the adaptive layer
probe (train/auto_layers.py) on its own key and trains only the offsets of
the top ``auto_layer_k`` layers, as the JAX trainer does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..clip import model as clip_model
from ..inversion import encoders as enc_lib
from ..metrics import vgg16 as vgg16_lib
from ..models import stylegan2 as sg2
from ..ops.resize import resize2d
from ..params import offsets as offs_lib
from ..utils import checkpoint as ckpt
from ..utils.config import to_dict
from ..utils.observability import trace_scope
from . import adapt_losses as al
from . import auto_layers
from .train_step import Adam

Params = Dict[str, Any]

TRAINERS = ("td_single", "im2im_single", "im2im_JoJo", "im2im_difa")
# The side of the images e4e encodes in the SCC loss (the reference resizes
# to 256 before its encoder).
E4E_SIZE = 256


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


def _to_host(losses: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The losses as floats, in one device-to-host copy."""
    values = torch.stack([v.float() for v in losses.values()])
    with trace_scope("host_read.adapt_losses"):
        values = values.tolist()
    return dict(zip(losses, values))


def _frozen(tree: Params) -> Params:
    """The tree's tensors, detached: they never require grad."""
    return {k: _frozen(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


def _unit_tokens(t: torch.Tensor) -> torch.Tensor:
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)


class AdaptationTrainer:
    """Trains offsets against a frozen generator and frozen CLIP towers.

    clip_encoders: {name: (CLIPConfig, params)} for each visual encoder.
    domain_embeddings: {name: {"src": [1, D] or [1, T, D], "trg": ...}},
      text embeddings over T templates (td_single; the direction loss
      averages them) or image embeddings; the im2im trainers fill in what
      is not given from the style image.
    rng: the trainer's draw tree (utils/rng.py ``Rng``, or any object with
      its methods, e.g. one backed by ``jax.random`` in tests); split once
      for the offsets' random factors, then once a step.
    offsets: an initial offsets tree to start from instead of
      ``init_offsets`` (copied to ``device``).
    style_image / style_image_inverted_A: uint8 [C, H, W] (im2im);
      style_latents: W+ [1, num_ws, w_dim] of the style image.
    latent_encoder: (EncoderConfig, params) of e4e, which the SCC loss
      needs.
    lpips_params: VGG16-LPIPS weights for ``lpips_rec`` (random, seed 11,
      when it is asked for and none are given).
    """

    def __init__(self, cfg: AdaptationConfig, g_cfg: sg2.GeneratorConfig,
                 g_params: Params,
                 clip_encoders: Dict[str, Tuple[clip_model.CLIPConfig,
                                                Params]],
                 rng, domain_embeddings: Optional[
                     Dict[str, Dict[str, torch.Tensor]]] = None,
                 device="cuda", offsets: Optional[Params] = None,
                 style_image: Optional[np.ndarray] = None,
                 style_latents=None,
                 style_image_inverted_A: Optional[np.ndarray] = None,
                 latent_encoder: Optional[Tuple[enc_lib.EncoderConfig,
                                                Params]] = None,
                 lpips_params: Optional[Params] = None):
        self.check_config(cfg)
        self.cfg, self.g_cfg = cfg, g_cfg
        self.device = torch.device(device)
        self.g_params = _frozen(g_params)
        self.clip_encoders = {n: (c, _frozen(p))
                              for n, (c, p) in clip_encoders.items()}
        if cfg.loss.scc is not None and latent_encoder is None:
            raise ValueError("the SCC loss (difa_w) needs latent_encoder, "
                             "the e4e encoder of the style latents")
        self._latent_cfg, self._latent_params = (
            (latent_encoder[0], _frozen(latent_encoder[1]))
            if latent_encoder else (None, None))
        self._lpips_params = None
        if "lpips_rec" in cfg.loss.loss_funcs:
            if lpips_params is None:
                lpips_params = vgg16_lib.init_vgg16(
                    torch.Generator().manual_seed(11), with_classifier=False,
                    device=self.device)
            self._lpips_params = _frozen(lpips_params)
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

        def image(a):
            return (None if a is None else torch.as_tensor(
                np.asarray(a), device=self.device)[None])

        self.style_image = image(style_image)
        self._style_rec = None
        self.style_inverted_A = image(style_image_inverted_A)
        self.style_latents = (None if style_latents is None else
                              torch.as_tensor(np.asarray(style_latents),
                                              dtype=torch.float32,
                                              device=self.device))
        self.domain_embeddings = {n: _frozen(e) for n, e in
                                  (domain_embeddings or {}).items()}
        self._prepare_constants()

        self.scc_state = None
        if cfg.loss.scc is not None:
            # e4e's style heads are 512 wide whatever the generator's w_dim.
            self.scc_state = al.init_scc_state(
                cfg.loss.scc.num_keep_first * 512,
                window=cfg.loss.scc.sliding_window_size, device=self.device)

    @staticmethod
    def check_config(cfg: AdaptationConfig):
        """Raises for a trainer that does not exist."""
        if cfg.trainer not in TRAINERS:
            raise ValueError(f"unknown trainer {cfg.trainer!r}")

    # ------------------------------------------------------------------

    def _encode(self, name, images, return_hidden=()):
        ccfg, cparams = self.clip_encoders[name]
        img = torch.clamp(images * 127.5 + 128, 0, 255)
        dtype = torch.bfloat16 if self.cfg.clip_dtype == "bfloat16" else None
        return clip_model.encode_image(ccfg, cparams, img,
                                       return_hidden=return_hidden,
                                       dtype=dtype)

    @property
    def renders_style_latents(self) -> bool:
        """Whether a step renders the style latents through the offsets:
        JoJo always; im2im_single and im2im_difa when a loss reads the
        render (a reconstruction loss or clip_ref).  The JAX step computes
        the render always and XLA drops it when nothing reads it."""
        cfg = self.cfg
        if cfg.trainer == "im2im_JoJo":
            return True
        return (cfg.trainer in ("im2im_single", "im2im_difa")
                and self.style_latents is not None
                and any(f in al.rec_losses or f == "clip_ref"
                        for f in cfg.loss.loss_funcs))

    @property
    def _want_tokens(self) -> bool:
        cfg = self.cfg
        return (cfg.trainer == "im2im_difa" and cfg.use_difa_tokens
                and any("trg_tokens_style" in self.domain_embeddings.get(n, {})
                        for n in cfg.visual_encoders))

    def _prepare_constants(self):
        """The style image's CLIP embeddings and DiFa tokens; JoJo's
        swapped layers."""
        cfg = self.cfg
        if cfg.trainer in ("im2im_single", "im2im_difa") and \
                self.style_image is not None:
            style_f = self.style_image.float() / 127.5 - 1.0
            inv_a = (self.style_inverted_A.float() / 127.5 - 1.0
                     if self.style_inverted_A is not None else style_f)
            layers = ((cfg.clip_layer,) if cfg.trainer == "im2im_difa"
                      and cfg.use_difa_tokens else ())
            with torch.no_grad():
                for name in cfg.visual_encoders:
                    trg_emb, hid = self._encode(name, style_f, layers)
                    src_emb, _ = self._encode(name, inv_a)
                    entry = self.domain_embeddings.setdefault(name, {})
                    entry.setdefault("trg", trg_emb)
                    entry.setdefault("src", src_emb)
                    if layers:
                        entry["trg_tokens_style"] = _unit_tokens(
                            hid[cfg.clip_layer][0])
        if cfg.trainer == "im2im_JoJo":
            n_latent = self.g_cfg.num_ws
            self.id_swap = ([i for i in (9, 11, 15, 16, 17) if i < n_latent]
                            if cfg.preserve_color else
                            list(range(7, n_latent)))

    # ------------------------------------------------------------------

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

    def _rec_data(self, inverted_b):
        """The reconstruction pair at full size and at 256^2 (Keys cubic,
        antialiased, as jax.image.resize "cubic"); the style image's side is
        a constant of the trainer."""
        if self._style_rec is None:
            style_f = self.style_image.float() / 127.5 - 1.0
            self._style_rec = {
                "style_image_1024x1024": style_f,
                "style_image_256x256": resize2d(style_f, (256, 256),
                                                "bicubic")}
        return {"style_inverted_B_1024x1024": inverted_b,
                "style_inverted_B_256x256": resize2d(inverted_b, (256, 256),
                                                     "bicubic"),
                **self._style_rec}

    def _latent_of(self, images):
        """Flat e4e latents [N, style_count * 512] of images for the SCC
        loss."""
        # Named for profiler traces.
        with trace_scope("e4e"):
            x = resize2d(images.float(), (E4E_SIZE, E4E_SIZE), "bilinear")
            ws = enc_lib.e4e_encode(self._latent_cfg, self._latent_params, x)
        return ws.reshape(ws.shape[0], -1)

    def losses(self, offsets: Params, key, scc_state=None, cur_iter: int = 0):
        """(the step's losses with 'total', the new SCC state) at
        ``offsets`` on the draws of ``key``: z, z2, the mixing gate and the
        noise key."""
        cfg, g_cfg = self.cfg, self.g_cfg
        k_z, k_z2, k_mix, k_noise = key.split(4)
        z = k_z.normal((cfg.batch_size, g_cfg.z_dim), self.device)
        z2 = k_z2.normal((cfg.batch_size, g_cfg.z_dim), self.device)
        use_mix = k_mix.uniform((), self.device) < cfg.mixing_noise
        hooks = offs_lib.make_hooks(self.spec, offsets)
        use_scc = cfg.loss.scc is not None
        if cfg.trainer != "im2im_JoJo" or use_scc:
            frozen_img, trainable_img = self._images(offsets, z, z2, use_mix,
                                                     k_noise)

        def synth(latents):
            return sg2.synthesis_apply(g_cfg.synthesis,
                                       self.g_params["synthesis"], latents,
                                       noise_mode="const", hooks=hooks)

        clip_data, rec_data = {}, {}
        if cfg.trainer == "im2im_JoJo":
            # The style latents with the batch's mapped latents mixed in at
            # the swapped layers.
            ws = sg2.mapping_apply(g_cfg.mapping, self.g_params["mapping"], z)
            a = 1.0 - cfg.alpha
            in_latent = self.style_latents.repeat(cfg.batch_size, 1, 1)
            idx = torch.tensor(self.id_swap, device=self.device)
            mixed = a * in_latent[:, idx] + (1 - a) * ws[:, idx]
            in_latent = in_latent.clone()
            in_latent[:, idx] = mixed
            rec_data = self._rec_data(synth(in_latent))
        else:
            want_tokens = self._want_tokens
            layers = (cfg.clip_layer,) if want_tokens else ()
            for name in cfg.visual_encoders:
                # One tower pass over [trainable; frozen]: the ViT treats
                # the samples independently, so this equals two passes.
                both, hid = self._encode(
                    name, torch.cat([trainable_img, frozen_img]), layers)
                trg_enc, src_enc = both.chunk(2)
                emb = self.domain_embeddings[name]
                cb = {"trg_encoded": trg_enc, "src_encoded": src_enc,
                      "trg_domain_emb": emb["trg"],
                      "src_domain_emb": emb["src"]}
                if want_tokens:
                    trg_tok, src_tok = hid[cfg.clip_layer].chunk(2)
                    cb["trg_tokens"] = _unit_tokens(trg_tok)
                    cb["src_tokens"] = _unit_tokens(src_tok)
                    cb["trg_tokens_style"] = emb["trg_tokens_style"]
                clip_data[name] = cb
            if self.renders_style_latents:
                inverted_b = synth(self.style_latents)
                rec_data = self._rec_data(inverted_b)
                if "clip_ref" in cfg.loss.loss_funcs:
                    for name in cfg.visual_encoders:
                        clip_data[name]["trg_trainable_emb"] = self._encode(
                            name, inverted_b)[0]
                        clip_data[name]["trg_emb"] = \
                            self.domain_embeddings[name]["trg"]

        if self._lpips_params is not None and rec_data:
            # The style image is a constant: gradients flow through the
            # inverted-B side only.
            lp = self._lpips_params
            rec_data["style_inverted_B_lpips"] = vgg16_lib.vgg16_lpips(
                lp, (rec_data["style_inverted_B_256x256"] + 1) * 127.5)
            rec_data["style_image_lpips"] = vgg16_lib.vgg16_lpips(
                lp, (rec_data["style_image_256x256"] + 1) * 127.5)

        inv_data = {}
        if use_scc:
            with torch.no_grad():
                src_latents = self._latent_of(frozen_img)
            inv_data = {"src_latents": src_latents,
                        "trg_latents": self._latent_of(trainable_img),
                        "iters": cur_iter, "total_iters": cfg.iter_num}
        return al.direct_loss(cfg.loss, {"clip_data": clip_data,
                                         "rec_data": rec_data,
                                         "offsets": offsets,
                                         "inv_data": inv_data}, scc_state)

    def _loss_and_grads(self, key):
        leaves = self.tx.trainable(self.offsets)
        for t in leaves.values():
            t.requires_grad_(True)
        try:
            with trace_scope("adapt.losses"):
                losses, scc_state = self.losses(self.offsets, key,
                                                self.scc_state,
                                                self.current_step)
            with trace_scope("adapt.grad"):
                grads = torch.autograd.grad(losses["total"],
                                            list(leaves.values()),
                                            allow_unused=True)
        finally:
            for t in leaves.values():
                t.requires_grad_(False)
        grads = {k: g if g is not None else torch.zeros_like(t)
                 for (k, t), g in zip(leaves.items(), grads)}
        # Freeing the step's autograd graph is host time of its own.
        with trace_scope("adapt.free_graph"):
            losses = {k: v.detach() for k, v in losses.items()}
        return losses, grads, scc_state

    def loss_and_grads(self, key):
        """(losses, {dotted key: gradient}) at the current offsets, for the
        trainable leaves only; the SCC window is left as it was."""
        losses, grads, _ = self._loss_and_grads(key)
        return losses, grads

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
        with trace_scope("adapt.step", device=True):
            cfg = self.cfg
            self.rng, k_step, k_auto = self.rng.split(3)
            losses, grads, self.scc_state = self._loss_and_grads(k_step)
            with trace_scope("adapt.update"):
                if cfg.auto_layer_iters > 0:
                    mask = self._auto_layer_mask(k_auto)
                    grads = {k: g * mask[k] for k, g in grads.items()}
                if cfg.weight_decay:
                    leaves = self.tx.trainable(self.offsets)
                    grads = {k: g + cfg.weight_decay * leaves[k]
                             for k, g in grads.items()}
                lr = cfg.lr
                if cfg.lr_warmup_steps > 0:
                    lr = cfg.lr * min(self.opt_state.count,
                                      cfg.lr_warmup_steps) \
                        / cfg.lr_warmup_steps
                dataclasses.replace(self.tx, lr=lr).update_(
                    grads, self.opt_state, self.offsets)
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
