"""The direction models of the port against the JAX package's, on the same
numpy inputs: the flat StyleSpace vector (params/sparse.py), the synthesis
forward from explicit styles (``synthesis_from_styles``), the adaptive layer
probe (train/auto_layers.py, its noise and latents injected as JAX's draws
through ``JaxRng``) and the trainer's layer mask, and the text-conditioned
mappers (params/mappers.py, weights drawn on JAX's key tree).

Tiny setup: G at 32^2 (channel_base 1024, channel_max 64, z/w 32, 2 mapping
layers), CLIP 2 layers of width 64 (``entry.TINY_CLIP``), float32.
Tolerances: forward 2e-4 of max|.| (the suite's), gradients and the probe's
scores (lr * |gradient| sums) 1e-3 of their max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.clip import model as jclip
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.params import mappers as jmp
from gagan_tpu.params import offsets as joffs
from gagan_tpu.params import sparse as jsp
from gagan_tpu.train import auto_layers as jauto
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch import entry
from gagan_tpu_torch.clip import model as tclip
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.params import mappers as tmp
from gagan_tpu_torch.params import offsets as toffs
from gagan_tpu_torch.params import sparse as tsp
from gagan_tpu_torch.train import adapt_losses as tal
from gagan_tpu_torch.train import adaptation as tad
from gagan_tpu_torch.train import auto_layers as tauto
from gagan_tpu_torch.utils import checkpoint as tck

from .test_torch_augment import JaxRng

torch.set_num_threads(2)


def _cfg(m, **syn):
    return m.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=32,
        mapping=m.MappingConfig(num_layers=2),
        synthesis=m.SynthesisConfig(channel_base=1024, channel_max=64, **syn))


@pytest.fixture(scope="module")
def g_weights():
    """JAX's init of the tiny G, noise strengths and biases non-zero."""
    flat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0),
                                               _cfg(jsg)))
    rng = np.random.RandomState(0)
    for k, v in flat.items():
        if k.endswith("noise_strength"):
            flat[k] = np.float32(rng.uniform(0.1, 0.3))
        elif k.endswith(".bias") and ".affine." not in k:
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return flat


def _close(got, want, rel=2e-4):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12))


# ----------------------------------------------------------------------------
# The flat StyleSpace vector


@pytest.mark.parametrize("res", [32, 256, 1024])
def test_sparse_index_maps_match_jax(res):
    jsyn, tsyn = (jsg.SynthesisConfig(img_resolution=res),
                  tsg.SynthesisConfig(img_resolution=res))
    assert tsp.conv_layer_names(tsyn) == jsp.conv_layer_names(jsyn)
    assert tsp.conv_style_dims(tsyn) == jsp.conv_style_dims(jsyn)
    assert tsp.flat_dim(tsyn) == jsp.flat_dim(jsyn)
    assert tsp.conv_to_style_layer_index(tsyn) == \
        jsp.conv_to_style_layer_index(jsyn)
    assert tsp.w_idx_to_style_idx(tsyn) == jsp.w_idx_to_style_idx(jsyn)
    if res == 1024:
        assert tsp.flat_dim(tsyn) == 6048


@pytest.mark.parametrize("perc", [0.0, 0.3, 0.5, 0.99])
def test_sparse_vector_matches_jax(perc):
    jsyn, tsyn = _cfg(jsg).synthesis, _cfg(tsg).synthesis
    dim = tsp.flat_dim(tsyn)
    deltas = np.random.RandomState(1).randn(dim).astype(np.float32)
    deltas[::7] = deltas[3]               # ties in |delta|
    jd, td = jnp.asarray(deltas), torch.from_numpy(deltas)
    for got, want in zip(tsp.split_flat(tsyn, td), jsp.split_flat(jsyn, jd)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    toff, joff = tsp.to_offsets(tsyn, td), jsp.to_offsets(jsyn, jd)
    assert sorted(toff) == sorted(joff)
    for k in joff:
        np.testing.assert_array_equal(toff[k]["offset"].numpy(),
                                      np.asarray(joff[k]["offset"]))
    np.testing.assert_array_equal(tsp.from_offsets(tsyn, toff).numpy(),
                                  deltas)
    np.testing.assert_array_equal(tsp.pruned(td, perc).numpy(),
                                  np.asarray(jsp.pruned(jd, perc)))


def test_sparse_hooks_image_matches_jax(g_weights):
    deltas = (0.3 * np.random.RandomState(2).randn(
        tsp.flat_dim(_cfg(tsg).synthesis))).astype(np.float32)
    z = np.random.RandomState(3).randn(2, 32).astype(np.float32)
    want = jsg.generator_apply(
        _cfg(jsg), jck.flat_to_tree(g_weights), jnp.asarray(z),
        hooks=jsp.to_hooks(_cfg(jsg).synthesis, jnp.asarray(deltas)))
    with torch.no_grad():
        got = tsg.generator_apply(
            _cfg(tsg), tck.flat_to_tree(g_weights), torch.from_numpy(z),
            hooks=tsp.to_hooks(_cfg(tsg).synthesis, torch.from_numpy(deltas)))
    _close(got, want)


# ----------------------------------------------------------------------------
# synthesis_from_styles


@pytest.mark.parametrize("noise_mode,hooked", [
    ("const", False), ("random", False), ("none", False), ("const", True)])
def test_synthesis_from_styles_matches_jax(g_weights, noise_mode, hooked):
    """The same styles (JAX's generator_styles, perturbed) through both
    functions; with ``hooked`` an Affine+ weight offset on b16 as well.
    The port's G has pallas_level and bf16 on: the function takes neither,
    as the JAX one does not."""
    jcfg = _cfg(jsg)
    tcfg = _cfg(tsg, pallas_level=True, num_fp16_res=2, conv_clamp=256)
    jcfg_c = _cfg(jsg, conv_clamp=256)
    params = jck.flat_to_tree(g_weights)
    z = np.random.RandomState(4).randn(3, 32).astype(np.float32)
    ws = jsg.mapping_apply(jcfg.mapping, params["mapping"], jnp.asarray(z))
    styles = [s * (1 + 0.3 * jax.random.normal(jax.random.PRNGKey(i), s.shape))
              for i, s in enumerate(jsg.generator_styles(
                  jcfg.synthesis, params["synthesis"], ws))]
    jhooks = thooks = None
    if hooked:
        parts = ("synt_weights_offset.b16", "tRGB_weights_offset.b16")
        jspec = joffs.OffsetsSpec.from_string("out_in_additive", parts)
        joff = joffs.init_offsets(jax.random.PRNGKey(5), jcfg.synthesis, jspec)
        rng = np.random.RandomState(6)
        oflat = {k: (0.05 * rng.randn(*np.shape(v))).astype(np.float32)
                 for k, v in jck.tree_to_flat(joff).items()}
        jhooks = joffs.make_hooks(jspec, jck._merge_layer_keys(
            jck.flat_to_tree(oflat)))
        thooks = toffs.make_hooks(
            toffs.OffsetsSpec.from_string("out_in_additive", parts),
            tck._merge_layer_keys(tck.flat_to_tree(oflat)))
    key = jax.random.PRNGKey(7)
    want = jsg.synthesis_from_styles(jcfg_c.synthesis, params["synthesis"],
                                     styles, noise_mode=noise_mode, rng=key,
                                     hooks=jhooks)
    with torch.no_grad():
        got = tsg.synthesis_from_styles(
            tcfg.synthesis, tck.flat_to_tree(g_weights)["synthesis"],
            [torch.from_numpy(np.asarray(s)) for s in styles],
            noise_mode=noise_mode, generator=JaxRng(key), hooks=thooks)
    assert got.dtype == torch.float32
    _close(got, want)


def test_synthesis_from_styles_inverts_generator_styles(g_weights):
    """From generator_styles(ws) the function gives synthesis_apply(ws)
    (const noise, float32)."""
    cfg = _cfg(tsg)
    params = tck.flat_to_tree(g_weights)
    z = torch.from_numpy(np.random.RandomState(8).randn(2, 32).astype(
        np.float32))
    with torch.no_grad():
        ws = tsg.mapping_apply(cfg.mapping, params["mapping"], z)
        styles = tsg.generator_styles(cfg.synthesis, params["synthesis"], ws)
        via_s = tsg.synthesis_from_styles(cfg.synthesis, params["synthesis"],
                                          styles)
        direct = tsg.synthesis_apply(cfg.synthesis, params["synthesis"], ws)
    _close(via_s, direct.numpy(), rel=1e-5)
    with pytest.raises(ValueError, match="noise_mode"):
        tsg.synthesis_from_styles(cfg.synthesis, params["synthesis"], styles,
                                  noise_mode="bogus")


# ----------------------------------------------------------------------------
# The adaptive layer probe


@pytest.fixture(scope="module")
def clip_weights():
    ccfg = jclip.CLIPConfig(**entry.TINY_CLIP)
    return jck.tree_to_flat(jclip.init_clip(jax.random.PRNGKey(1), ccfg))


@pytest.mark.parametrize("target_shape", [(1, 32), (1, 5, 32)])
def test_auto_layer_scores_match_jax(g_weights, clip_weights, target_shape):
    """Two SGD steps on W+ against the global CLIP loss, random layer noise
    from JAX's keys: the [num_ws] scores, the chosen layers and the mask."""
    iters, k = 2, 4
    target = np.random.RandomState(9).randn(*target_shape).astype(np.float32)
    z = np.random.RandomState(10).randn(3, 32).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jscore = jauto.make_layer_score_fn(
        _cfg(jsg), jclip.CLIPConfig(**entry.TINY_CLIP), iters, lr=0.05)
    want = np.asarray(jscore(jck.flat_to_tree(g_weights),
                             jck.flat_to_tree(clip_weights),
                             jnp.asarray(target), jnp.asarray(z), key))
    tscore = tauto.make_layer_score_fn(
        _cfg(tsg), tclip.CLIPConfig(**entry.TINY_CLIP), iters, lr=0.05)
    got = tscore(tck.flat_to_tree(g_weights), tck.flat_to_tree(clip_weights),
                 torch.from_numpy(target), torch.from_numpy(z), JaxRng(key))
    assert got.shape == (_cfg(tsg).num_ws,) and bool((got > 0).all())
    _close(got, want, rel=1e-3)
    names = _cfg(tsg).synthesis.layer_names()
    chosen = tauto.choose_layers(got, names, k)
    assert chosen == jauto.choose_layers(want, names, k)
    assert len(chosen) == k and names[-1] not in chosen
    offsets = toffs.init_offsets(JaxRng(key), _cfg(tsg).synthesis,
                                 toffs.OffsetsSpec.from_string("s_delta"))
    joffsets = joffs.init_offsets(key, _cfg(jsg).synthesis,
                                  joffs.OffsetsSpec.from_string("s_delta"))
    tmask = tck.tree_to_flat(tauto.layer_grad_mask(offsets, chosen))
    jmask = jck.tree_to_flat(jauto.layer_grad_mask(joffsets, chosen))
    assert {k2: float(v) for k2, v in tmask.items()} == {
        k2: float(v) for k2, v in jmask.items()}


def test_determine_opt_layers_names_k_layers(g_weights, clip_weights):
    """The one-call probe (the trainer's shape): k names among the layers,
    finite scores, and G / CLIP left without gradients."""
    params = tck.flat_to_tree(g_weights)
    cparams = tck.flat_to_tree(clip_weights)
    chosen, scores = tauto.determine_opt_layers(
        JaxRng(jax.random.PRNGKey(12)), _cfg(tsg), params,
        tclip.CLIPConfig(**entry.TINY_CLIP), cparams,
        torch.randn((1, 32), generator=torch.Generator().manual_seed(0)),
        auto_layer_iters=1, auto_layer_batch=2, auto_layer_k=3)
    assert len(chosen) == 3 and set(chosen) <= set(
        _cfg(tsg).synthesis.layer_names())
    assert bool(torch.isfinite(scores).all())
    for tree in (params, cparams):
        assert not any(t.requires_grad or t.grad is not None
                       for t in tck.tree_to_flat_tensors(tree).values())


def test_trainer_trains_only_the_chosen_layers():
    """td_single with auto_layer_iters > 0: one step moves the offsets of
    the probe's k layers and no others (zero gradients elsewhere, and
    Adam's moments start at zero)."""
    trainer = entry.adapt_entry("cpu", batch=2)
    cfg = tad.AdaptationConfig(**{
        **{f: getattr(trainer.cfg, f) for f in (
            "trainer", "batch_size", "lr", "parametrization",
            "visual_encoders", "source_class", "target_class")},
        "auto_layer_iters": 1, "auto_layer_batch": 2, "auto_layer_k": 3,
        "loss": tal.DirectLossConfig(loss_funcs=("direction",),
                                     loss_coefs=(1.0,))})
    trainer = tad.AdaptationTrainer(
        cfg, trainer.g_cfg, trainer.g_params, trainer.clip_encoders,
        JaxRng(jax.random.PRNGKey(13)), trainer.domain_embeddings,
        device="cpu")
    before = {k: v.clone() for k, v in tck.tree_to_flat_tensors(
        trainer.offsets).items()}
    losses = trainer.train_step()
    assert np.isfinite(losses["total"])
    moved = {k.rsplit(".", 1)[0] for k, v in tck.tree_to_flat_tensors(
        trainer.offsets).items() if not torch.equal(v, before[k])}
    assert len(moved) == 3 and moved <= set(trainer.g_cfg.synthesis.layer_names())


# ----------------------------------------------------------------------------
# Mappers


MAPPERS = [
    dict(mapper_type="residual_channelwise_sep"),
    dict(mapper_type="base_channelwise_sep", activation="lrelu"),
    dict(mapper_type="residual_channelin", head_depth=3),
    dict(mapper_type="levelsheads_channelwise_sep", backbone_type="levels",
         no_medium=True),
]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kw", MAPPERS, ids=[m["mapper_type"] for m in MAPPERS])
def test_mapper_matches_jax(kw, train, g_weights):
    """init_mapper on JAX's key tree gives JAX's weights; mapper_apply (BN
    in train and eval mode) gives JAX's offsets, and their hooks JAX's
    image; the gradient of an image loss reaches the mapper as in JAX."""
    jcfg, tcfg = (jmp.MapperConfig(width=32, input_dimension=16, **kw),
                  tmp.MapperConfig(width=32, input_dimension=16, **kw))
    syn_j, syn_t = _cfg(jsg).synthesis, _cfg(tsg).synthesis
    key = jax.random.PRNGKey(14)
    jparams = jmp.init_mapper(key, jcfg, syn_j)
    tparams = tmp.init_mapper(JaxRng(key), tcfg, syn_t)
    jflat, tflat = jck.tree_to_flat(jparams), tck.tree_to_flat(tparams)
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        np.testing.assert_allclose(tflat[k], np.asarray(v), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    rng = np.random.RandomState(15)
    # Non-trivial running statistics for the eval-mode BN.
    for k in jflat:
        if k.endswith("running_mean"):
            jflat[k] = tflat[k] = rng.randn(*tflat[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            jflat[k] = tflat[k] = rng.uniform(0.5, 2, tflat[k].shape).astype(
                np.float32)
    jparams, tparams = jck.flat_to_tree(jflat), tck.flat_to_tree(tflat)
    emb = rng.randn(8, 16).astype(np.float32)
    jout = jmp.mapper_apply(jparams, jcfg, syn_j, jnp.asarray(emb), train)
    tout = tmp.mapper_apply(tparams, tcfg, syn_t, torch.from_numpy(emb), train)
    assert sorted(tout) == sorted(jout)
    for name, entry_ in jout.items():
        assert sorted(tout[name]) == sorted(entry_)
        for kind, v in entry_.items():
            _close(tout[name][kind], v)

    params = jck.flat_to_tree(g_weights)
    z = rng.randn(8, 32).astype(np.float32)
    scale = 20.0        # the 0.01-scaled init gives offsets of ~1e-3

    def jloss(mp_):
        out = jax.tree.map(lambda x: scale * x, jmp.mapper_apply(
            mp_, jcfg, syn_j, jnp.asarray(emb), train))
        img = jsg.generator_apply(_cfg(jsg), params, jnp.asarray(z),
                                  hooks=jmp.mapper_hooks(syn_j, out))
        return jnp.mean(jnp.square(img)), img

    (jl, jimg), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = tck.tree_to_flat_tensors(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    out = {n: {k2: scale * v for k2, v in e.items()} for n, e in
           tmp.mapper_apply(tparams, tcfg, syn_t, torch.from_numpy(emb),
                            train).items()}
    img = tsg.generator_apply(_cfg(tsg), tck.flat_to_tree(g_weights),
                              torch.from_numpy(z),
                              hooks=tmp.mapper_hooks(syn_t, out))
    img.square().mean().backward()
    _close(img, jimg)
    jg = {k: np.asarray(v) for k, v in jck.tree_to_flat(jgrad).items()}
    # A bias that feeds a train-mode batch norm has a zero gradient: both
    # packages give rounding noise there, held to 1e-6 of the largest
    # gradient of the tree.
    floor = 1e-6 * max(np.abs(v).max() for v in jg.values())
    for k, t in leaves.items():
        want = jg[k]
        got = t.grad.numpy() if t.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=max(1e-3 * np.abs(want).max(), floor),
            err_msg=k)
