"""Entry points of the port.

* :func:`entry`: the FFHQ-1024 StyleGAN2 generator forward, the counterpart
  of ``__graft_entry__.entry()`` of the JAX package, with the eligible
  synthesis levels routed through the fused modconv kernel
  (``pallas_level=True``).
* :func:`train_entry`: the adversarial train step at FFHQ-1024 on one card,
  the one-device counterpart of ``__graft_entry__.dryrun_multichip`` at
  full width, configured by the port's training CLI's plan for a 1024^2 run
  (``cli/train.py::build_run``, ``--cfg auto``).
* :func:`fewshot_entry`: the few-shot Affine+ adaptation step at
  FFHQ-1024 (``cli/train.py --use-domain-modulation``, the shape
  ``bench.py::bench_adapt10`` times): the train step with the b64 weight
  offsets and G's affines trained, everything else of G frozen.
* :func:`adapt_entry`: a one-shot CLIP adaptation trainer (``td_single``)
  at FFHQ-1024 with CLIP towers of the real shape, or at a tiny size for
  the CPU.
* :func:`im2im_entry`: the DiFa trainer (``im2im_difa`` with the e4e SCC
  loss) at the shape ``bench.py::bench_adaptation_difa`` times, or at a
  tiny size for the CPU.
* :func:`ga_entry`: the GA direction search of
  ``tools/bench_ga_search.py`` (a Swin-T fitness, 32 candidates of 4
  images) at FFHQ-1024, or at a tiny size for the CPU.
* :func:`restyle_entry`: a ReStyle net (any of the six encoder types) on
  the FFHQ-1024 generator and a batch of 256^2 inputs, for
  ``inversion.restyle.run_on_batch`` and ``inference.project_restyle``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from . import resolve_device
from .cli import adapt as adapt_cli
from .cli import train as train_cli
from .ga import search as ga_search
from .inversion import encoders as enc_lib
from .inversion import restyle as restyle_lib
from .models import stylegan2 as sg2
from .models import swin
from .params import offsets as offs_lib
from .train import adapt_losses as al
from .train import adaptation as ad
from .train import augment, train_step as ts
from .utils import checkpoint as ckpt_lib
from .utils.rng import Rng
from .utils.text_templates import imagenet_templates


def entry_config(pallas_level: bool = True) -> sg2.GeneratorConfig:
    """FFHQ-1024: bf16 from 128x128 up, conv_clamp 256, packed last block."""
    return sg2.GeneratorConfig(
        img_resolution=1024,
        synthesis=sg2.SynthesisConfig(num_fp16_res=4, conv_clamp=256,
                                      packed_last_block=True,
                                      pallas_level=pallas_level))


def entry(device="cuda", batch: int = 4):
    """Returns ``forward, (params, z)``: random FFHQ-1024 weights (seed 0)
    and a batch of latents (seed 1) on ``device``, and the const-noise
    generator forward over them.  Raises without CUDA unless ``device`` is
    'cpu'."""
    device = resolve_device(device)
    cfg = entry_config()
    params = sg2.init_generator(cfg, torch.Generator().manual_seed(0), device)
    z = torch.randn((batch, cfg.z_dim),
                    generator=torch.Generator().manual_seed(1)).to(device)

    def forward(params, z):
        with torch.no_grad():
            return sg2.generator_apply(cfg, params, z, noise_mode="const")

    return forward, (params, z)


# The few-shot Affine+ protocol of bench.py::bench_adapt10: G's affines and
# the b64 weight offsets train, at a generator lr of 0.02.
FEWSHOT_OPTIONS = dict(
    use_domain_modulation=True,
    domain_modulation_parametrization="out_in_additive",
    generator_requires_grad_parts="synt_affine,tRGB_affine,"
                                  "synt_weights_offset.b64,"
                                  "tRGB_weights_offset.b64",
    glrate=0.02)


def train_run(batch: int = 32, img_resolution: int = 1024,
              channel_base: Optional[int] = None, **options):
    """The training CLI's run (``cli/train.py::build_run``, ``--cfg auto``,
    the defaults, then ``options``) for ``batch`` RGB images at
    ``img_resolution``^2 on one card; ``channel_base`` overrides both
    networks' (for small CPU runs)."""
    run = train_cli.build_run(img_resolution, 3, 0, batch=batch, **options)
    if channel_base:
        run = dataclasses.replace(
            run, g_cfg=dataclasses.replace(
                run.g_cfg, synthesis=dataclasses.replace(
                    run.g_cfg.synthesis, channel_base=channel_base)),
            d_cfg=dataclasses.replace(run.d_cfg, channel_base=channel_base))
    return run


def train_configs(batch: int = 32, img_resolution: int = 1024,
                  channel_base: Optional[int] = None):
    """(g_cfg, d_cfg, train_cfg, augment_cfg) of :func:`train_run`: at
    FFHQ-1024 and batch 32, G is :func:`entry_config` with the CLI's 2
    mapping layers; D is resnet with the packed first block, bf16 in its 4
    highest resolutions and conv_clamp 256; the phases run in rounds of at
    most 8 live samples (Greg 16); the ADA pipe is ``bgc`` in bf16."""
    run = train_run(batch, img_resolution, channel_base)
    return run.g_cfg, run.d_cfg, run.train_cfg, run.augment_cfg


def train_entry(device="cuda", batch: int = 32, img_resolution: int = 1024,
                channel_base: Optional[int] = None, ada_p: float = 0.0):
    """Returns ``steps, state, inputs``:

    * ``steps``: the three step variants a run schedules, {"none": Gmain +
      Dmain, "greg": + Greg, "both": + Greg + Dreg} (Greg every 4 batches,
      Dreg every 16), each ``step(state, real, real_c, z, gen_c, key) ->
      (state, metrics)``, as the training loop builds them.  Greg runs with
      ``pallas_level=False``: the fused level is differentiable once and
      the path length needs twice.  At 1024^2 the R1 phase runs a remat'd
      D (the CLI's ``reg_remat``).
    * ``state``: random weights (G from seed 0, D from seed 1), Adam state,
      ``ada_p`` as given.
    * ``inputs``: (real images in [-1, 1], None, z, None, key), from seeds
      2 and 3, on ``device``.

    Raises without CUDA unless ``device`` is 'cpu'."""
    device = resolve_device(device)
    return _run_steps(train_run(batch, img_resolution, channel_base), device,
                      batch, ada_p)


def fewshot_entry(device="cuda", batch: int = 32, img_resolution: int = 1024,
                  channel_base: Optional[int] = None, ada_p: float = 0.0):
    """:func:`train_entry` for the run of ``cli/train.py --cfg auto --batch
    32 --use-domain-modulation --domain-modulation-parametrization
    out_in_additive --generator-requires-grad-parts synt_affine,tRGB_affine,
    synt_weights_offset.b64,tRGB_weights_offset.b64 --glrate 0.02``
    (:data:`FEWSHOT_OPTIONS`): the state also holds the offsets (zeros from
    ``init_offsets``, their EMA and Adam state), and every G phase trains
    G's affines and the b64 weight offsets together.  Raises without CUDA
    unless ``device`` is 'cpu'."""
    device = resolve_device(device)
    return _run_steps(train_run(batch, img_resolution, channel_base,
                                **FEWSHOT_OPTIONS), device, batch, ada_p)


def _run_steps(run, device, batch: int, ada_p: float):
    g_cfg, d_cfg, cfg, aug_cfg = (run.g_cfg, run.d_cfg, run.train_cfg,
                                  run.augment_cfg)
    r1_d_cfg = dataclasses.replace(d_cfg, remat=True) if run.reg_remat else None
    g_params = sg2.init_generator(g_cfg, torch.Generator().manual_seed(0),
                                  device)
    d_params = sg2.init_discriminator(d_cfg, torch.Generator().manual_seed(1),
                                      device)
    g_tx, d_tx, _, _ = ts.build_optimizers(cfg, g_params, d_params)
    state = ts.init_train_state(cfg, g_params, d_params, g_tx, d_tx)
    state.ada_p = torch.tensor(float(ada_p), device=device)
    spec = offsets_tx = None
    if run.parametrization:
        spec = offs_lib.OffsetsSpec.from_string(run.parametrization,
                                                weight_parts=run.parts)
        offsets = offs_lib.init_offsets(Rng(4), g_cfg.synthesis, spec, device)
        offsets_tx = ts.build_offsets_optimizer(cfg, spec, offsets, run.parts)
        ts.init_offsets_state(state, offsets, offsets_tx)
    pl_g_cfg = dataclasses.replace(g_cfg, synthesis=dataclasses.replace(
        g_cfg.synthesis, pallas_level=False))
    augment_fn = augment.make_augment_fn(aug_cfg)
    steps: Dict[str, object] = {}
    for name, do_g, do_d in (("none", False, False), ("greg", True, False),
                             ("both", True, True)):
        steps[name] = ts.make_fused_step(
            cfg, g_cfg, d_cfg, g_tx, d_tx, augment_fn=augment_fn,
            do_g_reg=do_g, do_d_reg=do_d, reg_g_cfg=pl_g_cfg if do_g else None,
            reg_d_cfg=r1_d_cfg if do_d else None, offsets_spec=spec,
            offsets_tx=offsets_tx)
    gen = torch.Generator().manual_seed(2)
    res = g_cfg.img_resolution
    real = (torch.rand((batch, g_cfg.img_channels, res, res), generator=gen)
            * 2 - 1).to(device)
    z = torch.randn((batch, g_cfg.z_dim), generator=gen).to(device)
    return steps, state, (real, None, z, None, Rng(3))


# The tiny sizes of the CPU adaptation runs: G at 32^2, and every CLIP tower
# 2 layers of width 64 with 8x8 patches of a 32^2 image.
TINY_G = sg2.GeneratorConfig(
    z_dim=32, w_dim=32, img_resolution=32,
    mapping=sg2.MappingConfig(num_layers=2),
    synthesis=sg2.SynthesisConfig(channel_base=1024, channel_max=64))
TINY_CLIP = dict(embed_dim=32, image_resolution=32, vision_layers=2,
                 vision_width=64, vision_patch_size=8, transformer_width=32,
                 transformer_heads=4, transformer_layers=2,
                 vision_heads_override=4)


def adapt_entry(device="cuda", batch: int = 4,
                visual_encoders=("ViT-B/32",),
                loss_funcs=("direction", "offsets_l2"),
                loss_coefs=(1.0, 0.1), pallas_level: bool = True,
                clip_dtype: str = "bfloat16",
                g_params=None) -> ad.AdaptationTrainer:
    """A ``td_single`` trainer as ``cli/adapt.py`` builds it from
    ``configs/td_nada_sdelta.yaml`` (s_delta offsets, lr 0.08): "Photo" ->
    "Anime" text embeddings over the ImageNet templates, random CLIP towers
    (seed 0, byte tokenizer), the trainer's draws from ``Rng(0)``, and a
    random generator (seed 0) unless ``g_params`` is given.  On CUDA: G is
    :func:`entry_config` (FFHQ-1024, 8 mapping layers, ``pallas_level``)
    and the towers have the real ViT-B shapes; on the CPU: :data:`TINY_G`
    and :data:`TINY_CLIP`.  Raises without CUDA unless ``device`` is
    'cpu'."""
    device = resolve_device(device)
    tiny = device.type == "cpu"
    g_cfg = TINY_G if tiny else entry_config(pallas_level)
    if g_params is None:
        g_params = sg2.init_generator(g_cfg, torch.Generator().manual_seed(0),
                                      device)
    encoders = adapt_cli.load_clip_encoders(visual_encoders, device,
                                            TINY_CLIP if tiny else None)
    cfg = ad.AdaptationConfig(
        trainer="td_single", batch_size=batch, lr=0.08,
        parametrization="s_delta", visual_encoders=tuple(visual_encoders),
        source_class="Photo", target_class="Anime", clip_dtype=clip_dtype,
        loss=al.DirectLossConfig(loss_funcs=tuple(loss_funcs),
                                 loss_coefs=tuple(loss_coefs)))
    emb = adapt_cli.text_embeddings(encoders, cfg.source_class,
                                    cfg.target_class, imagenet_templates)
    return ad.AdaptationTrainer(cfg, g_cfg, g_params, encoders, Rng(0), emb,
                                device=device)


def im2im_entry(device="cuda", batch: int = 4, pallas_level: bool = True,
                clip_dtype: str = "bfloat16",
                g_params=None) -> ad.AdaptationTrainer:
    """The DiFa trainer of ``bench.py::bench_adaptation_difa``: s_delta
    offsets, clip_layer 8, direction + difa_local (1.0 each) and the SCC
    loss (weight 6.0) on e4e latents, a random 1024^2 style image
    (``RandomState(11)``) and no style latents, random CLIP towers (seed 0),
    random unit domain embeddings (``torch.Generator`` seed 10 + i), a
    random e4e (seed 5, convolutions rescaled by
    :func:`rescale_random_convs`: unscaled, its latents reach ~1e10), the
    trainer's draws from ``Rng(3)`` and a random
    generator (seed 0) unless ``g_params`` is given.  On CUDA: G is
    :func:`entry_config` (``pallas_level``), the towers ViT-B, e4e IR-SE-50
    with 18 style heads; on the CPU: :data:`TINY_G`, :data:`TINY_CLIP` and
    e4e with the 8 heads of a 32^2 generator.  Raises without CUDA unless
    ``device`` is 'cpu'."""
    device = resolve_device(device)
    tiny = device.type == "cpu"
    g_cfg = TINY_G if tiny else entry_config(pallas_level)
    if g_params is None:
        g_params = sg2.init_generator(g_cfg, torch.Generator().manual_seed(0),
                                      device)
    visual_encoders = ("ViT-B/32", "ViT-B/16")
    encoders = adapt_cli.load_clip_encoders(visual_encoders, device,
                                            TINY_CLIP if tiny else None)
    emb = {}
    for i, (name, (ccfg, _)) in enumerate(encoders.items()):
        e = torch.randn((2, ccfg.embed_dim),
                        generator=torch.Generator().manual_seed(10 + i))
        e = (e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)).to(device)
        emb[name] = {"src": e[:1], "trg": e[1:]}
    res = g_cfg.img_resolution
    style_image = np.random.RandomState(11).randint(0, 255, (3, res, res),
                                                    np.uint8)
    e_cfg = enc_lib.EncoderConfig(stylegan_size=res)
    e_params = enc_lib.init_encoder(torch.Generator().manual_seed(5), e_cfg,
                                    device)
    rescale_random_convs(e_params)
    cfg = ad.AdaptationConfig(
        trainer="im2im_difa", batch_size=batch, iter_num=301,
        parametrization="s_delta", clip_layer=1 if tiny else 8,
        visual_encoders=visual_encoders, clip_dtype=clip_dtype,
        loss=al.DirectLossConfig(
            loss_funcs=("direction", "difa_local"), loss_coefs=(1.0, 1.0),
            scc=al.SCCConfig(weight=6.0)))
    return ad.AdaptationTrainer(cfg, g_cfg, g_params, encoders, Rng(3), emb,
                                device=device, style_image=style_image,
                                latent_encoder=(e_cfg, e_params))


# The tiny Swin of the CPU runs: two stages on a 32^2 image, 4x4 windows.
TINY_SWIN = swin.SwinConfig(image_size=32, embed_dim=16, depths=(2, 2),
                            num_heads=(2, 4), window_size=4)


class GAEntry(NamedTuple):
    g_cfg: sg2.GeneratorConfig
    g_params: Dict
    extract: Callable        # images in [-1, 1] -> pooled Swin features
    fitness_fn: Callable     # one candidate's images in [0, 255] -> score
    cfg: ga_search.GASearchConfig


def ga_entry(device="cuda", eval_mode: str = "scan", generations: int = 2,
             g_params=None) -> GAEntry:
    """The GA search of ``tools/bench_ga_search.py``: the fitness of a
    candidate is the mean cosine of its images' pooled Swin features (a
    random tower, seed 1) to a fixed unit target (seed 2);
    ``GASearchConfig(population=32, batch_per_candidate=4, elite=4)`` with
    ``eval_mode`` and ``generations``; a random generator (seed 0) unless
    ``g_params`` is given.  On CUDA: G is :func:`entry_config`
    (FFHQ-1024, the fused level) and the tower Swin-T on the raw 1024^2
    image; on the CPU: :data:`TINY_G` and :data:`TINY_SWIN`.  Raises
    without CUDA unless ``device`` is 'cpu'."""
    device = resolve_device(device)
    tiny = device.type == "cpu"
    g_cfg = TINY_G if tiny else entry_config()
    if g_params is None:
        g_params = sg2.init_generator(g_cfg, torch.Generator().manual_seed(0),
                                      device)
    s_cfg = TINY_SWIN if tiny else swin.swin_tiny_config()
    extract = swin.make_feature_extractor(
        s_cfg, gen=torch.Generator().manual_seed(1), device=device)
    dim = s_cfg.embed_dim * 2 ** (len(s_cfg.depths) - 1)     # 768 for Swin-T
    target = torch.randn((dim,), generator=torch.Generator().manual_seed(2))
    target = (target / torch.linalg.vector_norm(target)).to(device)

    def fitness_fn(img_u8):
        feats = extract(img_u8.float() / 127.5 - 1.0)
        feats = feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
                         + 1e-8)
        return (feats @ target).mean()

    cfg = ga_search.GASearchConfig(population=32, batch_per_candidate=4,
                                   elite=4, generations=generations,
                                   eval_mode=eval_mode)
    return GAEntry(g_cfg, g_params, extract, fitness_fn, cfg)


# The tiny generator of CPU ReStyle runs: 256^2 (the encoders' input size,
# 14 W+ layers) and narrow, with the encoders' 512-wide w.
TINY_RESTYLE_G = sg2.GeneratorConfig(
    img_resolution=256, mapping=sg2.MappingConfig(num_layers=2),
    synthesis=sg2.SynthesisConfig(channel_base=1024, channel_max=64))


# The random ReStyle heads' linear weights are multiplied by this: with the
# convolutions rescaled alone, the codes' change grew 2.2-2.4x an iteration
# (3.8 -> 183 over 5, H100 runs); the head is linear and bias-free at init,
# so the factor scales each iteration's change and the loop's gain with it.
RESTYLE_HEAD_SCALE = 0.02


def rescale_random_convs(params) -> None:
    """Multiply, in place, each 4-D convolution weight of a random encoder
    (drawn at std 0.05, ``enc._init_conv``) so that its std is
    1/sqrt(fan-in): unit gain a layer instead of ~0.05 * sqrt(fan-in)."""
    for w in ckpt_lib.tree_to_flat_tensors(params).values():
        if w.ndim == 4:
            w.mul_(1.0 / (0.05 * np.sqrt(w[0].numel())))


def restyle_entry(device="cuda", encoder_type: str = "ProgressiveBackboneEncoder",
                  batch: int = 4, pallas_level: bool = True,
                  tiny: bool = False, g_params=None):
    """Returns ``net, inputs``: a ``RestyleNet`` of ``encoder_type`` on a
    random generator (seed 0) unless ``g_params`` is given, and [batch, 3,
    256, 256] inputs uniform in [-1, 1] (seed 3).  The encoder is random
    (``torch.Generator`` seed 1, 6-channel input) with each convolution
    rescaled by :func:`rescale_random_convs` (at the init's 0.05 the codes
    pass 1e20 and G's demodulation overflows) and each style head's linear
    weight by :data:`RESTYLE_HEAD_SCALE`, so that the decode-to-encoder
    loop contracts: an iteration's change of the codes stays a small
    fraction of ``latent_avg`` over 5 iterations.  ``latent_avg`` is the mapping's mean w over 4096 latents
    (seed 2), on every layer.  G is
    :func:`entry_config` (FFHQ-1024, 18 W+ layers, ``pallas_level``), or
    :data:`TINY_RESTYLE_G` with ``tiny``.  Raises without CUDA unless
    ``device`` is 'cpu'."""
    device = resolve_device(device)
    g_cfg = TINY_RESTYLE_G if tiny else entry_config(pallas_level)
    if g_params is None:
        g_params = sg2.init_generator(g_cfg, torch.Generator().manual_seed(0),
                                      device)
    e_cfg = restyle_lib.RestyleEncoderConfig(encoder_type=encoder_type,
                                             stylegan_size=g_cfg.img_resolution)
    e_params = restyle_lib.init_restyle_encoder(
        torch.Generator().manual_seed(1), e_cfg, device)
    rescale_random_convs(e_params)
    for head in e_params["styles"].values():
        head["linear"]["weight"].mul_(RESTYLE_HEAD_SCALE)
    z = torch.randn((4096, g_cfg.z_dim),
                    generator=torch.Generator().manual_seed(2)).to(device)
    with torch.no_grad():
        w_avg = sg2.mapping_apply(g_cfg.mapping, g_params["mapping"], z,
                                  broadcast=False).mean(dim=0)
    net = restyle_lib.RestyleNet(
        enc_cfg=e_cfg, enc_params=e_params, g_cfg=g_cfg, g_params=g_params,
        latent_avg=w_avg[None].repeat(e_cfg.style_count, 1))
    inputs = (torch.rand((batch, 3, 256, 256),
                         generator=torch.Generator().manual_seed(3)) * 2
              - 1).to(device)
    return net, inputs
