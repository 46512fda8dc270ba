"""The port's image-driven trainers (gagan_tpu_torch/train/adaptation.py:
``im2im_single``, ``im2im_JoJo``, ``im2im_difa`` with the SCC loss) against
the JAX package's ``AdaptationTrainer`` on the same weights and the same
draws (JAX's key tree injected as ``JaxRng``).

Tiny setup (tests/test_adaptation.py's): G at 32^2 with non-zero noise
strengths, a 2-layer CLIP of width 64 in fp32, batch 2, a random 32^2
style image with random W+ style latents and a random inverted-A image.
Each trainer starts from the same non-zero offsets and takes 3 Adam steps.
DiFa's steps are held in tests/test_torch_im2im_difa.py.

Tolerances, PR 5's for the trainer: losses 2e-4 relative (and, for a
cosine loss near 0, its coefficient times 2^-23: the rounding of a cosine
near 1 in fp32); the gradients
(Adam's first moments) 1e-3 of their max; offsets after each step 1e-3 of
the learning rate; the SCC window 2e-4 of its max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.clip import model as jclip
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.train import adapt_losses as jal
from gagan_tpu.train import adaptation as jad
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch import entry
from gagan_tpu_torch.clip import model as tclip
from gagan_tpu_torch.train import adapt_losses as tal
from gagan_tpu_torch.train import adaptation as tad
from gagan_tpu_torch.utils import checkpoint as tck
from .test_torch_adaptation import _jax_first_moments
from .test_torch_augment import JaxRng
from .test_torch_encoders import JCFG as E_JCFG
from .test_torch_encoders import TCFG as E_TCFG
from .test_torch_vgg16 import vgg_flat

torch.set_num_threads(2)

LR = 0.05


@pytest.fixture(scope="module")
def setup():
    """G and CLIP flat weights, the style inputs."""
    jcfg = jsg.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=32,
        mapping=jsg.MappingConfig(num_layers=2),
        synthesis=jsg.SynthesisConfig(channel_base=1024, channel_max=64))
    gflat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0), jcfg))
    gflat = {k: (np.float32(0.2) if k.endswith("noise_strength") else v)
             for k, v in gflat.items()}
    cflat = jck.tree_to_flat(jclip.init_clip(
        jax.random.PRNGKey(1), jclip.CLIPConfig(**entry.TINY_CLIP)))
    rng = np.random.RandomState(2)
    style = {"style_image": rng.randint(0, 255, (3, 32, 32), np.uint8),
             "style_latents": rng.randn(1, jcfg.num_ws, 32).astype(
                 np.float32) * 0.5,
             "style_image_inverted_A": rng.randint(0, 255, (3, 32, 32),
                                                   np.uint8)}
    return jcfg, gflat, cflat, style


def _trainers(setup, trainer, loss_funcs, loss_coefs, extra=None, scc=None,
              **cfg_kw):
    jcfg, gflat, cflat, style = setup
    extra = extra or {}
    kw = dict(trainer=trainer, batch_size=2, iter_num=3, lr=LR,
              parametrization="additive", clip_dtype="float32",
              mixing_noise=0.9)
    kw.update(cfg_kw)
    key = jax.random.PRNGKey(5)
    jkw, tkw = {}, {}
    if "lpips" in extra:
        jkw["lpips_params"] = jck.flat_to_tree(extra["lpips"])
        tkw["lpips_params"] = tck.flat_to_tree(extra["lpips"])
    if "e4e" in extra:
        jkw["latent_encoder"] = (E_JCFG, jck.flat_to_tree(extra["e4e"]))
        tkw["latent_encoder"] = (E_TCFG, tck.flat_to_tree(extra["e4e"]))
    jtr = jad.AdaptationTrainer(
        jad.AdaptationConfig(**kw, loss=jal.DirectLossConfig(
            loss_funcs=loss_funcs, loss_coefs=loss_coefs,
            scc=scc and jal.SCCConfig(**scc))),
        jcfg, jck.flat_to_tree(gflat),
        {"ViT-B/32": (jclip.CLIPConfig(**entry.TINY_CLIP),
                      jck.flat_to_tree(cflat))},
        key, style_image=style["style_image"],
        style_latents=jnp.asarray(style["style_latents"]),
        style_image_inverted_A=style["style_image_inverted_A"], **jkw)
    rng = np.random.RandomState(1)
    start = {k: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32)
             for k, v in jck.tree_to_flat(jtr.offsets).items()}
    jtr.offsets = jck._merge_layer_keys(jck.flat_to_tree(start))
    ttr = tad.AdaptationTrainer(
        tad.AdaptationConfig(**kw, loss=tal.DirectLossConfig(
            loss_funcs=loss_funcs, loss_coefs=loss_coefs,
            scc=scc and tal.SCCConfig(**scc))),
        entry.TINY_G, tck.flat_to_tree(gflat),
        {"ViT-B/32": (tclip.CLIPConfig(**entry.TINY_CLIP),
                      tck.flat_to_tree(cflat))},
        JaxRng(key), device="cpu",
        offsets=tck._merge_layer_keys(tck.flat_to_tree(start)),
        style_image=style["style_image"],
        style_latents=style["style_latents"],
        style_image_inverted_A=style["style_image_inverted_A"], **tkw)
    return jtr, ttr


def _steps_match(jtr, ttr, steps=3):
    loss = ttr.cfg.loss
    coefs = dict(zip(loss.loss_funcs, loss.loss_coefs))
    for step in range(steps):
        want = jtr.train_step()
        got = ttr.train_step()
        assert sorted(got) == sorted(want)
        for k in want:
            # coef * (1 - cos) keeps fp32's rounding of cos near 1 (2^-24)
            # times its coefficient.
            np.testing.assert_allclose(
                got[k], want[k], rtol=2e-4,
                atol=1e-6 + 2 ** -23 * coefs.get(k.split("_ViT")[0], 1.0),
                err_msg=f"{k} at step {step}")
        moments = _jax_first_moments(jtr.opt_state)
        assert sorted(moments) == sorted(ttr.opt_state.mu)
        for k, v in moments.items():
            np.testing.assert_allclose(ttr.opt_state.mu[k].numpy(), v, rtol=0,
                                       atol=1e-3 * np.abs(v).max(), err_msg=k)
        jflat = jck.tree_to_flat(jtr.offsets)
        tflat = tck.tree_to_flat(ttr.offsets)
        assert sorted(jflat) == sorted(tflat)
        for k in jflat:
            np.testing.assert_allclose(tflat[k], jflat[k], rtol=0,
                                       atol=1e-3 * LR, err_msg=k)
    return got


def test_im2im_single_steps_match_jax(setup):
    """MindTheGap with the full reference loss stack: direction,
    clip_within, clip_ref (the inverted-B embedding), l2_rec_resized and
    lpips_rec (VGG16-LPIPS of the 256^2 pair)."""
    jtr, ttr = _trainers(
        setup, "im2im_single",
        ("direction", "clip_within", "clip_ref", "l2_rec_resized",
         "lpips_rec"), (1.0, 0.5, 30.0, 10.0, 10.0),
        extra={"lpips": vgg_flat(2)})
    got = _steps_match(jtr, ttr)
    assert {"clip_ref_ViT-B-32", "lpips_rec", "l2_rec_resized"} <= set(got)
    assert got["lpips_rec"] > 0


def test_im2im_single_cin_mult_steps_match_jax(setup):
    """MindTheGap on the other patch key of configs/im2im_*.yaml
    (multiplicative StyleSpace offsets), im2im_mtg.yaml's losses."""
    jtr, ttr = _trainers(setup, "im2im_single",
                         ("clip_within", "l2_rec_resized", "offsets_l2"),
                         (1.0, 5.0, 0.1), parametrization="cin_mult")
    _steps_match(jtr, ttr)


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_im2im_jojo_steps_match_jax(setup, alpha):
    """JoJoGAN: the style latents mixed with the batch's mapped latents at
    layers 7 and up, rendered through the offsets; l2_rec_fullres and
    offsets_l2."""
    jtr, ttr = _trainers(setup, "im2im_JoJo", ("l2_rec_fullres",
                                               "offsets_l2"), (1.0, 0.1),
                         alpha=alpha)
    assert ttr.id_swap == jtr.id_swap == [7]
    _steps_match(jtr, ttr)


def test_reference_fault_im2im_direction_is_inert(setup):
    """A fault of the JAX package's adapt command: it builds the im2im
    trainers without ``style_image_inverted_A`` (gagan_tpu/cli/adapt.py:
    231-253), so the source embedding is the style image's own
    (gagan_tpu/train/adaptation.py:199-208) and the domain edit of the
    ``direction`` loss is exactly zero.  The loss is then the constant 1
    with no gradient: im2im_difa.yaml's direction term trains nothing.  The
    port reproduces it."""
    jcfg, gflat, cflat, style = setup
    kw = dict(trainer="im2im_difa", batch_size=2, iter_num=2, lr=LR,
              parametrization="additive", clip_dtype="float32", clip_layer=1)
    jtr = jad.AdaptationTrainer(
        jad.AdaptationConfig(**kw, loss=jal.DirectLossConfig(
            loss_funcs=("direction",), loss_coefs=(1.0,))),
        jcfg, jck.flat_to_tree(gflat),
        {"ViT-B/32": (jclip.CLIPConfig(**entry.TINY_CLIP),
                      jck.flat_to_tree(cflat))},
        jax.random.PRNGKey(6), style_image=style["style_image"],
        style_latents=jnp.asarray(style["style_latents"]))
    ttr = tad.AdaptationTrainer(
        tad.AdaptationConfig(**kw, loss=tal.DirectLossConfig(
            loss_funcs=("direction",), loss_coefs=(1.0,))),
        entry.TINY_G, tck.flat_to_tree(gflat),
        {"ViT-B/32": (tclip.CLIPConfig(**entry.TINY_CLIP),
                      tck.flat_to_tree(cflat))},
        JaxRng(jax.random.PRNGKey(6)), device="cpu",
        style_image=style["style_image"],
        style_latents=style["style_latents"])
    for tr in (jtr, ttr):
        for _ in range(2):
            assert tr.train_step()["direction_ViT-B-32"] == 1.0
    assert all(float(np.abs(np.asarray(v)).max()) == 0 for v in
               jck.tree_to_flat(jtr.offsets).values())
    assert all(float(v.abs().max()) == 0 for v in
               tck.tree_to_flat_tensors(ttr.offsets).values())


def test_trainers_refuse_unknown_names():
    for name in ("td_single", "im2im_single", "im2im_JoJo", "im2im_difa"):
        tad.AdaptationTrainer.check_config(tad.AdaptationConfig(trainer=name))
    with pytest.raises(ValueError, match="unknown trainer"):
        tad.AdaptationTrainer.check_config(tad.AdaptationConfig(
            trainer="im2im_jojo"))
