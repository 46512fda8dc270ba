"""The port's td_single trainer (gagan_tpu_torch.train.adaptation) against
the JAX package's on the same weights and the same draws: the JAX key tree
is handed to the port as its draw source (``JaxRng``), so z, z2, the mixing
gate, the crossover layer, the layer noise and the offsets' random factors
are JAX's numbers.

Tiny setup (tests/test_adaptation.py's): G at 32^2, a 2-layer CLIP of width
64 with 8x8 patches, batch 2, CLIP in fp32.  Both trainers start from the
same non-zero offsets, so the trainable and frozen images differ, and take
two Adam steps.  Tolerances: losses 2e-4 relative (the suite's fp32
forward); the gradients (Adam's first moments) 1e-3 of their max (the
suite's); offsets after each step 1e-3 of the learning rate, since Adam
moves each entry by about lr * g / |g| and an error of 1e-4 relative in g
moves it by far less.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gagan_tpu.clip import model as jclip
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.train import adapt_losses as jal
from gagan_tpu.train import adaptation as jad
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch import entry
from gagan_tpu_torch.clip import model as tclip
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.train import adapt_losses as tal
from gagan_tpu_torch.train import adaptation as tad
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils.config import generator_config_from_dict \
    as tsg_config
from .test_torch_augment import JaxRng

torch.set_num_threads(2)

LR = 0.05


@pytest.fixture(scope="module")
def setup():
    """(JAX G config, G flat weights, CLIP flat weights, embeddings)."""
    jcfg = jsg.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=32,
        mapping=jsg.MappingConfig(num_layers=2),
        synthesis=jsg.SynthesisConfig(channel_base=1024, channel_max=64))
    gflat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0), jcfg))
    gflat = {k: (np.float32(0.2) if k.endswith("noise_strength") else v)
             for k, v in gflat.items()}
    ccfg = jclip.CLIPConfig(**entry.TINY_CLIP)
    cflat = jck.tree_to_flat(jclip.init_clip(jax.random.PRNGKey(1), ccfg))
    rng = np.random.RandomState(0)
    emb = {"src": rng.randn(1, 5, 32).astype(np.float32),
           "trg": rng.randn(1, 5, 32).astype(np.float32)}
    return jcfg, gflat, cflat, emb


def _trainers(setup, parametrization, loss_funcs, loss_coefs, scale=0.05):
    jcfg, gflat, cflat, emb = setup
    kw = dict(trainer="td_single", batch_size=2, iter_num=2, lr=LR,
              parametrization=parametrization, clip_dtype="float32",
              mixing_noise=0.9)
    key = jax.random.PRNGKey(5)
    jtr = jad.AdaptationTrainer(
        jad.AdaptationConfig(**kw, loss=jal.DirectLossConfig(
            loss_funcs=loss_funcs, loss_coefs=loss_coefs)),
        jcfg, jck.flat_to_tree(gflat),
        {"ViT-B/32": (jclip.CLIPConfig(**entry.TINY_CLIP),
                      jck.flat_to_tree(cflat))},
        key, domain_embeddings={"ViT-B/32": jax.tree.map(jnp.asarray, emb)})
    # Non-zero starting offsets in both (the same numbers).
    rng = np.random.RandomState(1)
    start = {k: (v + scale * rng.randn(*v.shape)).astype(np.float32)
             for k, v in jck.tree_to_flat(jtr.offsets).items()}
    jtr.offsets = jck._merge_layer_keys(jck.flat_to_tree(start))
    ttr = tad.AdaptationTrainer(
        tad.AdaptationConfig(**kw, loss=tal.DirectLossConfig(
            loss_funcs=loss_funcs, loss_coefs=loss_coefs)),
        entry.TINY_G, tck.flat_to_tree(gflat),
        {"ViT-B/32": (tclip.CLIPConfig(**entry.TINY_CLIP),
                      tck.flat_to_tree(cflat))},
        JaxRng(key), {"ViT-B/32": {k: torch.from_numpy(v)
                                   for k, v in emb.items()}},
        device="cpu",
        offsets=tck._merge_layer_keys(tck.flat_to_tree(start)))
    return jtr, ttr


def _jax_first_moments(opt_state):
    """{dotted key: Adam's first moment} of the JAX trainer's trainable
    leaves (after step t: sum_s 0.1 * 0.9^(t-s) * g_s, linear in the
    gradients)."""
    adam = next(leaf for leaf in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(leaf, optax.ScaleByAdamState))
    flat = jax.tree_util.tree_flatten_with_path(
        adam.mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]
    return {".".join(str(p.key) for p in path): np.asarray(v)
            for path, v in flat if not isinstance(v, optax.MaskedNode)}


# The low-rank weight offsets start at a larger perturbation: their effect
# on the images is second order in it, and the CLIP edit between two nearly
# equal images loses the digits the two packages' fp32 sums differ in.
@pytest.mark.parametrize("parametrization,loss_funcs,loss_coefs,scale", [
    ("s_delta", ("direction", "offsets_l2"), (1.0, 0.1), 0.05),
    ("out_in_1_2_additive", ("direction", "offsets_l1"), (1.0, 0.1), 0.5),
], ids=["s_delta_joint", "weights_two_pass"])
def test_td_single_steps_match_jax(setup, parametrization, loss_funcs,
                                   loss_coefs, scale):
    jtr, ttr = _trainers(setup, parametrization, loss_funcs, loss_coefs,
                         scale)
    assert ttr.spec.per_sample_only == (parametrization == "s_delta")
    for step in range(2):
        want = jtr.train_step()
        got = ttr.train_step()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-6,
                                       err_msg=f"{k} at step {step}")
        # The gradients, through Adam's first moment: 1e-3 of each max.
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
    assert ttr.current_step == 2 and ttr.opt_state.count == 2


def test_frozen_trees_hold_no_grad(setup):
    _, ttr = _trainers(setup, "s_delta", ("direction",), (1.0,))
    ttr.train_step()
    frozen = [ttr.g_params] + [p for _, p in ttr.clip_encoders.values()]
    for tree in frozen:
        for k, t in tck.tree_to_flat_tensors(tree).items():
            assert not t.requires_grad and t.grad is None, k
    for t in tck.tree_to_flat_tensors(ttr.offsets).values():
        assert not t.requires_grad and t.grad is None


def test_steps_move_offsets_and_adapt_the_images(tmp_path):
    """The port alone (its own Rng): zero offsets, a few steps move them,
    train() logs on its cadence and checkpoints, synthesize differs from
    the source."""
    trainer = entry.adapt_entry("cpu", batch=2)
    trainer.cfg = dataclasses.replace(trainer.cfg, iter_num=5, log_every=2,
                                      checkpoint_every=4)
    assert all(float(t.abs().max()) == 0 for t in
               tck.tree_to_flat_tensors(trainer.offsets).values())
    logged = []
    trainer.train(log_fn=lambda s, l: logged.append((s, l)),
                  checkpoint_dir=str(tmp_path))
    assert [s for s, _ in logged] == [0, 2, 4]
    assert all(np.isfinite(l["total"]) for _, l in logged)
    assert os.listdir(tmp_path) == ["adaptation-000004.npz"]
    assert max(float(t.abs().max()) for t in
               tck.tree_to_flat_tensors(trainer.offsets).values()) > 0
    z = torch.randn((2, 32), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        source = tsg.generator_apply(trainer.g_cfg, trainer.g_params, z)
    assert not torch.allclose(trainer.synthesize(z), source)


@pytest.mark.parametrize("trainer,match", [
    ("im2im_single", "11b"), ("im2im_JoJo", "11b"), ("im2im_difa", "11b")])
def test_unported_trainers_raise(trainer, match):
    with pytest.raises(NotImplementedError, match=match):
        tad.AdaptationTrainer.check_config(tad.AdaptationConfig(
            trainer=trainer))


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="11b"):
        tad.AdaptationTrainer.check_config(tad.AdaptationConfig(
            auto_layer_iters=5))
    with pytest.raises(NotImplementedError, match="item 12"):
        tad.AdaptationTrainer.check_config(tad.AdaptationConfig(
            loss=tal.DirectLossConfig(scc=tal.SCCConfig())))


def test_adaptation_npz_round_trip_across_packages(tmp_path):
    spec_str = "s_delta,out_in_1_2_additive"
    rng = np.random.RandomState(2)
    off = {"b4.conv1": {"offset": rng.randn(1, 64).astype(np.float32),
                        "weights_offset_in_0": rng.randn(1, 64).astype(
                            np.float32)},
           "b32.torgb": {"offset": rng.randn(1, 32).astype(np.float32)}}
    extra = {"style_latents": rng.randn(1, 8, 32).astype(np.float32)}
    g_cfg = jconfig.to_dict(jsg.GeneratorConfig(img_resolution=32))
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tck.save_adaptation(tpath, model_type="parametrization",
                        parametrization=spec_str,
                        offsets=tck.flat_to_tree(tck.tree_to_flat(off)),
                        sg2_config=g_cfg, extra_state=extra)
    jck.save_adaptation(jpath, model_type="parametrization",
                        parametrization=spec_str, offsets=off,
                        sg2_config=g_cfg, extra_state=extra)
    for path in (tpath, jpath):
        jmeta, joff, jextra = jck.load_adaptation(path)
        tmeta, toff, textra = tck.load_adaptation(path)
        assert tmeta == jmeta
        assert (tmeta["model_type"], tmeta["parametrization"]) == (
            "parametrization", spec_str)
        assert tsg_config(tmeta["sg2_params"]) == tsg_config(g_cfg)
        assert sorted(toff) == sorted(joff) == sorted(off)
        for name in off:
            for k, v in off[name].items():
                np.testing.assert_array_equal(toff[name][k].numpy(), v)
                np.testing.assert_array_equal(np.asarray(joff[name][k]), v)
        np.testing.assert_array_equal(textra["style_latents"].numpy(),
                                      extra["style_latents"])
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
