"""The port's offsets grammar (gagan_tpu_torch.params.offsets) and layer
hooks (models/stylegan2.py) against the JAX package's.

Every grammar family: the parse, init_offsets on JAX's draws (a ``jax.random``
draw source, so the random factors are JAX's), trainable_mask, and
make_hooks -> synthesis_apply on one tiny generator (32^2, channel_max 64,
fp32, const noise, non-zero offsets) in two layouts: plain blocks, and the
packed last block with every block remat'd.  Forward tolerance: the suite's
fp32 2e-4 of max|img|; gradients 1e-3 of their max.  Also the "post" hook
(packed tail and fused level off), the joint frozen + trainable pass
(bit-equal halves) and generator_styles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.params import offsets as joffs
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.ops import fused_modconv as fmc
from gagan_tpu_torch.params import offsets as toffs
from gagan_tpu_torch.utils import checkpoint as tck
from .test_torch_augment import JaxRng

torch.set_num_threads(2)

FAMILIES = [
    "additive", "multiplicative", "additive_w_space", "multiplicative_w_space",
    "in", "out_additive", "spatial", "in_spatial_additive", "out_spatial",
    "out_in_additive", "out+in", "out+in_additive", "out_in_2",
    "out_in_2_dual_additive", "out_in_2_3", "out_in_2_3_train_in",
    "out_in_2_3_train_out_additive", "affine_out_in_2_3_additive",
    "affine_out_in_1_2", "s_delta,out_in_1_2_additive,affine_out_in_1_2",
    "cin_mult", "w_mod",
]


def _cfgs(packed=False, remat=False, res=32):
    def build(m):
        return m.GeneratorConfig(
            z_dim=32, w_dim=32, img_resolution=res,
            mapping=m.MappingConfig(num_layers=2),
            synthesis=m.SynthesisConfig(channel_base=1024, channel_max=64,
                                        packed_last_block=packed,
                                        remat=remat))
    return build(jsg), build(tsg)


@pytest.fixture(scope="module")
def weights():
    """Tiny G weights (JAX init) with non-zero noise strengths and biases."""
    jcfg, _ = _cfgs()
    flat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    for k, v in flat.items():
        if k.endswith("noise_strength"):
            flat[k] = np.float32(rng.uniform(0.05, 0.3))
        elif k.endswith(".bias") and ".affine." not in k:
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return flat


def _perturbed(flat, seed=1, scale=0.1):
    rng = np.random.RandomState(seed)
    return {k: (v + scale * rng.randn(*v.shape)).astype(np.float32)
            for k, v in flat.items()}


def _ws(jcfg, params, n=2, seed=2):
    z = jnp.asarray(np.random.RandomState(seed).randn(n, 32).astype(np.float32))
    return np.asarray(jsg.mapping_apply(jcfg.mapping, params["mapping"], z))


@pytest.mark.parametrize("name", FAMILIES)
def test_parse_and_init_match_jax(name):
    jspec = joffs.OffsetsSpec.from_string(name)
    tspec = toffs.OffsetsSpec.from_string(name)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    for part in (jspec.weights, jspec.affine_weights):
        if part:
            assert dataclasses.asdict(
                toffs.parse_weight_parametrization(part)) == \
                dataclasses.asdict(joffs.parse_weight_parametrization(part))
    assert tspec.per_sample_only == jspec.per_sample_only
    jcfg, tcfg = _cfgs()
    key = jax.random.PRNGKey(3)
    want = jck.tree_to_flat(joffs.init_offsets(key, jcfg.synthesis, jspec))
    got_tree = toffs.init_offsets(JaxRng(key), tcfg.synthesis, tspec)
    got = tck.tree_to_flat(got_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert tck.tree_to_flat(toffs.trainable_mask(tspec, got_tree)) == \
        jck.tree_to_flat(joffs.trainable_mask(jspec, jck.flat_to_tree(want)))


def test_weight_parts_and_bad_names():
    for parts in (("synt_weights_offset",), ("tRGB_weights_offset.b16",),
                  ("synt_weights_offset.b8", "tRGB_weights_offset")):
        jspec = joffs.OffsetsSpec.from_string("out_in_additive", parts)
        tspec = toffs.OffsetsSpec.from_string("out_in_additive", parts)
        jcfg, tcfg = _cfgs()
        for layer in jcfg.synthesis.layer_names():
            assert tspec.layer_has_weight_offsets(layer) == \
                jspec.layer_has_weight_offsets(layer)
    assert tcfg.synthesis.layer_names() == jcfg.synthesis.layer_names()
    assert tcfg.synthesis.layer_in_channels() == \
        jcfg.synthesis.layer_in_channels()
    for bad in ("out_in_x", "additive,multiplicative", "sideways"):
        with pytest.raises(ValueError):
            toffs.OffsetsSpec.from_string(bad)


def _hooked_images(name, layout, weights, seed=4):
    """(JAX image, port image) of make_hooks(offsets) -> synthesis_apply."""
    jcfg, tcfg = _cfgs(*layout)
    jspec = joffs.OffsetsSpec.from_string(name)
    tspec = toffs.OffsetsSpec.from_string(name)
    off = _perturbed(jck.tree_to_flat(joffs.init_offsets(
        jax.random.PRNGKey(3), jcfg.synthesis, jspec)), seed)
    jparams = jck.flat_to_tree(weights)
    ws = _ws(jcfg, jparams)
    want = jsg.synthesis_apply(
        jcfg.synthesis, jparams["synthesis"], jnp.asarray(ws),
        noise_mode="const",
        hooks=joffs.make_hooks(jspec, joffs_tree(off)))
    tparams = tck.flat_to_tree(weights)
    with torch.no_grad():
        got = tsg.synthesis_apply(
            tcfg.synthesis, tparams["synthesis"], torch.from_numpy(ws),
            noise_mode="const",
            hooks=toffs.make_hooks(tspec, offsets_tree(off)))
    return np.asarray(want), got.numpy()


def joffs_tree(flat):
    return jck._merge_layer_keys(jck.flat_to_tree(flat))


def offsets_tree(flat):
    return tck._merge_layer_keys(tck.flat_to_tree(flat))


@pytest.mark.parametrize("layout", [(False, False), (True, True)],
                         ids=["plain", "packed_remat"])
@pytest.mark.parametrize("name", FAMILIES)
def test_hooked_synthesis_matches_jax(name, layout, weights):
    want, got = _hooked_images(name, layout, weights)
    assert got.shape == want.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", ["s_delta", "out_in_2_3_additive",
                                  "affine_out_in_1_2_additive"])
def test_hooked_gradients_with_remat_match_jax(name, weights):
    """d(sum(img * r)) / d(offsets) through the packed tail (not remat'd
    with hooks) and remat'd plain blocks, against jax.grad."""
    jcfg, tcfg = _cfgs(packed=True, remat=True)
    jspec = joffs.OffsetsSpec.from_string(name)
    tspec = toffs.OffsetsSpec.from_string(name)
    off = _perturbed(jck.tree_to_flat(joffs.init_offsets(
        jax.random.PRNGKey(3), jcfg.synthesis, jspec)), 5, 0.05)
    jparams = jck.flat_to_tree(weights)
    ws = _ws(jcfg, jparams)
    r = np.random.RandomState(6).randn(2, 3, 32, 32).astype(np.float32)

    def jloss(o):
        img = jsg.synthesis_apply(jcfg.synthesis, jparams["synthesis"],
                                  jnp.asarray(ws), noise_mode="const",
                                  hooks=joffs.make_hooks(jspec, o))
        return jnp.sum(img * r)

    want = jck.tree_to_flat(jax.grad(jloss)(joffs_tree(off)))
    toff = offsets_tree(off)
    leaves = tck.tree_to_flat_tensors(toff)
    for t in leaves.values():
        t.requires_grad_(True)
    tparams = tck.flat_to_tree(weights)
    img = tsg.synthesis_apply(tcfg.synthesis, tparams["synthesis"],
                              torch.from_numpy(ws), noise_mode="const",
                              hooks=toffs.make_hooks(tspec, toff))
    grads = torch.autograd.grad((img * torch.from_numpy(r)).sum(),
                                list(leaves.values()))
    for (k, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0,
                                   atol=1e-3 * np.abs(want[k]).max() + 1e-7,
                                   err_msg=k)


def _post_pair(scale):
    """A "post" hook (per-channel affine of the conv output) in both
    frameworks."""
    def j(x):
        c = x.shape[1]
        s = jnp.asarray(scale[:c], x.dtype)[None, :, None, None]
        return x * s + 0.05
    def t(x):
        c = x.shape[1]
        s = torch.as_tensor(scale[:c]).to(x.dtype)[None, :, None, None]
        return x * s + 0.05
    return j, t


@pytest.mark.parametrize("layer", ["b32.conv1", "b32.torgb", "b8.conv0"])
def test_post_hook_matches_jax_and_unpacks_tail(layer, weights, monkeypatch):
    jcfg, tcfg = _cfgs(packed=True)
    scale = np.random.RandomState(7).uniform(0.5, 1.5, 64).astype(np.float32)
    jpost, tpost = _post_pair(scale)
    jparams = jck.flat_to_tree(weights)
    ws = _ws(jcfg, jparams)
    want = jsg.synthesis_apply(jcfg.synthesis, jparams["synthesis"],
                               jnp.asarray(ws), noise_mode="const",
                               hooks={layer: {"post": jpost}})
    tails = []
    tail = tsg._packed_tail
    monkeypatch.setattr(tsg, "_packed_tail",
                        lambda *a, **k: tails.append(1) or tail(*a, **k))
    with torch.no_grad():
        got = tsg.synthesis_apply(
            tcfg.synthesis, tck.flat_to_tree(weights)["synthesis"],
            torch.from_numpy(ws), noise_mode="const",
            hooks={layer: {"post": tpost}})
    # A post hook on a tail layer keeps the last block unpacked.
    assert len(tails) == (0 if layer.startswith("b32") else 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4 * np.abs(np.asarray(want)).max())


def test_post_hook_keeps_level_off_the_fused_op(monkeypatch):
    """At a shape the fused level serves (C_out 128, W 128), hooked styles
    and weight go into it; a "post" hook sends the layer to the composed
    path, which JAX takes there too."""
    rng = np.random.RandomState(8)
    lp = {"weight": rng.randn(128, 16, 3, 3).astype(np.float32),
          "bias": (rng.randn(128) * 0.1).astype(np.float32),
          "affine": {"weight": rng.randn(16, 32).astype(np.float32),
                     "bias": np.ones(16, np.float32)},
          "noise_const": rng.randn(4, 128).astype(np.float32),
          "noise_strength": np.float32(0.2)}
    x = rng.randn(2, 16, 4, 128).astype(np.float32)
    w = rng.randn(2, 32).astype(np.float32)
    so = (rng.randn(1, 16) * 0.2).astype(np.float32)
    wo = (rng.randn(128, 16, 1, 1) * 0.1).astype(np.float32)
    jpost, tpost = _post_pair(rng.uniform(0.5, 1.5, 128).astype(np.float32))
    calls = []
    level = fmc.fused_modconv_level
    monkeypatch.setattr(fmc, "fused_modconv_level",
                        lambda *a, **k: calls.append(1) or level(*a, **k))
    jcfg = jsg.SynthesisConfig(img_resolution=128, conv_clamp=256)
    tcfg = tsg.SynthesisConfig(img_resolution=128, conv_clamp=256,
                               pallas_level=True)
    filt_j = jsg.setup_filter(jcfg.resample_filter)
    filt_t = tsg.setup_filter(tcfg.resample_filter)
    for post in (False, True):
        jh = {"l": {"style": lambda s: s + jnp.asarray(so),
                    "weight": lambda v: v + jnp.asarray(wo)}}
        th = {"l": {"style": lambda s: s + torch.from_numpy(so),
                    "weight": lambda v: v + torch.from_numpy(wo)}}
        if post:
            jh["l"]["post"], th["l"]["post"] = jpost, tpost
        want = jsg.synthesis_layer_apply(
            jcfg, {k: jnp.asarray(v) if not isinstance(v, dict) else
                   {a: jnp.asarray(b) for a, b in v.items()}
                   for k, v in lp.items()},
            jnp.asarray(x), jnp.asarray(w), 4, 1, filt_j, "l",
            noise_mode="const", hooks=jh)
        tlp = tck.flat_to_tree(tck.tree_to_flat(lp))
        got = tsg.synthesis_layer_apply(
            tcfg, tlp, torch.from_numpy(x), torch.from_numpy(w), 4, 1,
            filt_t, "l", noise_mode="const", hooks=th)
        assert len(calls) == 1                  # the unhooked-post run only
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-4 * np.abs(np.asarray(want)).max())


def test_joint_pass_is_bit_equal_to_separate(weights):
    """make_hooks(batch_select): the first half of the joint pass equals the
    hook-free forward and the second half the hooked one, bit for bit."""
    _, tcfg = _cfgs(packed=True)
    tparams = tck.flat_to_tree(weights)
    jcfg, _ = _cfgs()
    ws = torch.from_numpy(_ws(jcfg, jck.flat_to_tree(weights), n=3))
    sel = torch.arange(6) >= 3
    for name in ("s_delta", "additive", "multiplicative", "w_delta"):
        spec = toffs.OffsetsSpec.from_string(name)
        assert spec.per_sample_only
        off = offsets_tree(_perturbed(tck.tree_to_flat(toffs.init_offsets(
            JaxRng(jax.random.PRNGKey(7)), tcfg.synthesis, spec)), 8))

        def run(w, hooks):
            with torch.no_grad():
                return tsg.synthesis_apply(tcfg.synthesis,
                                           tparams["synthesis"], w,
                                           noise_mode="const", hooks=hooks)

        joint = run(torch.cat([ws, ws]),
                    toffs.make_hooks(spec, off, batch_select=sel))
        plain = run(ws, None)
        hooked = run(ws, toffs.make_hooks(spec, off))
        assert torch.equal(joint[:3], plain), name
        assert torch.equal(joint[3:], hooked), name
        assert not torch.allclose(plain, hooked)

    wspec = toffs.OffsetsSpec.from_string("out_in_additive")
    assert not wspec.per_sample_only
    with pytest.raises(ValueError, match="per-sample"):
        toffs.make_hooks(wspec, toffs.init_offsets(
            JaxRng(jax.random.PRNGKey(7)), tcfg.synthesis, wspec),
            batch_select=sel)


def test_generator_styles_match_jax(weights):
    jcfg, tcfg = _cfgs()
    jparams = jck.flat_to_tree(weights)
    ws = _ws(jcfg, jparams)
    off = _perturbed(jck.tree_to_flat(joffs.init_offsets(
        jax.random.PRNGKey(3), jcfg.synthesis,
        joffs.OffsetsSpec.from_string("additive"))), 9)
    want = jsg.generator_styles(jcfg.synthesis, jparams["synthesis"],
                                jnp.asarray(ws), joffs.make_hooks(
                                    joffs.OffsetsSpec.from_string("additive"),
                                    joffs_tree(off)))
    got = tsg.generator_styles(tcfg.synthesis,
                               tck.flat_to_tree(weights)["synthesis"],
                               torch.from_numpy(ws), toffs.make_hooks(
                                   toffs.OffsetsSpec.from_string("additive"),
                                   offsets_tree(off)))
    assert len(got) == len(want) == len(tcfg.synthesis.layer_names())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4 * np.abs(np.asarray(w)).max())
