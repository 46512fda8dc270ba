"""The port's Swin-T backbone (gagan_tpu_torch/models/swin.py) against the
JAX package's, on a HuggingFace-layout state dict drawn here from a numpy
seed and read by both packages' ``params_from_hf``.  The sizes are
tests/test_swin.py's: 32^2 and 28^2 images with 4x4 windows, so the token
grids of both stages are padded (28^2: 7x7 tokens) and the odd blocks
shift (32^2: 8x8 tokens).  Forward tolerance 2e-4 of max|JAX|, the suite's
own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.models import swin as jswin
from gagan_tpu_torch.models import swin as tswin

torch.set_num_threads(2)

SMALL = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 4), window_size=4)


def hf_state_dict(cfg, seed=0):
    """A HuggingFace SwinModel state dict of ``cfg``'s shapes: weights of
    std 1/sqrt(fan_in), LayerNorms near 1, small biases, and
    relative-position tables of order one, so that every term matters."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    sd = {}

    def lin(prefix, dout, din, bias=True):
        sd[prefix + ".weight"] = r(dout, din, scale=1 / np.sqrt(din))
        if bias:
            sd[prefix + ".bias"] = r(dout, scale=0.1)

    def ln(prefix, dim):
        sd[prefix + ".weight"] = 1 + r(dim, scale=0.1)
        sd[prefix + ".bias"] = r(dim, scale=0.1)

    e, p = cfg.embed_dim, cfg.patch_size
    sd["embeddings.patch_embeddings.projection.weight"] = r(
        e, cfg.num_channels, p, p, scale=1 / np.sqrt(3 * p * p))
    sd["embeddings.patch_embeddings.projection.bias"] = r(e, scale=0.1)
    ln("embeddings.norm", e)
    for i, depth in enumerate(cfg.depths):
        dim = e * 2 ** i
        for b in range(depth):
            pre = f"encoder.layers.{i}.blocks.{b}"
            ln(f"{pre}.layernorm_before", dim)
            for name in ("query", "key", "value"):
                lin(f"{pre}.attention.self.{name}", dim, dim)
            sd[f"{pre}.attention.self.relative_position_bias_table"] = r(
                (2 * cfg.window_size - 1) ** 2, cfg.num_heads[i])
            lin(f"{pre}.attention.output.dense", dim, dim)
            ln(f"{pre}.layernorm_after", dim)
            lin(f"{pre}.intermediate.dense", int(dim * cfg.mlp_ratio), dim)
            lin(f"{pre}.output.dense", dim, int(dim * cfg.mlp_ratio))
        if i < len(cfg.depths) - 1:
            ln(f"encoder.layers.{i}.downsample.norm", 4 * dim)
            lin(f"encoder.layers.{i}.downsample.reduction", 2 * dim, 4 * dim,
                bias=False)
    return sd


def pair(image_size, seed=0, **kw):
    """(JAX config, JAX params, port config, port params) on one state
    dict."""
    kw = dict(SMALL, image_size=image_size, **kw)
    jcfg, tcfg = jswin.SwinConfig(**kw), tswin.SwinConfig(**kw)
    sd = hf_state_dict(tcfg, seed)
    return (jcfg, jswin.params_from_hf(sd, jcfg), tcfg,
            tswin.params_from_hf(sd, tcfg))


def _close(got, want, tol=2e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


def test_params_from_hf_matches_jax():
    jcfg, jp, tcfg, tp = pair(32)
    want, got = _leaves(jp), _leaves(tp)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert "layers.1.downsample.norm.weight" not in got     # last stage
    assert got["layers.0.blocks.1.rel_bias"].shape == (49, 2)


@pytest.mark.parametrize("size", [32, 28])
def test_swin_features_match_jax(size):
    jcfg, jp, tcfg, tp = pair(size, seed=size)
    x = np.random.RandomState(1).randn(2, 3, size, size).astype(np.float32)
    want = jswin.swin_features(jcfg, jp, jnp.asarray(x))
    got = tswin.swin_features(tcfg, tp, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 4, 4, 48)
    _close(got, want)


def test_shifted_windows_take_part():
    """At 32^2 the odd blocks shift: zeroing the shifted block's attention
    output changes the features, in both packages alike."""
    jcfg, jp, tcfg, tp = pair(32, seed=3)
    x = np.random.RandomState(2).randn(1, 3, 32, 32).astype(np.float32)
    for proj in (jp["layers"][0]["blocks"][1]["proj"],
                 tp["layers"][0]["blocks"][1]["proj"]):
        for k in proj:
            proj[k] = proj[k] * 0
    want = jswin.swin_features(jcfg, jp, jnp.asarray(x))
    got = tswin.swin_features(tcfg, tp, torch.from_numpy(x))
    _close(got, want)
    _, _, _, tp_full = pair(32, seed=3)
    full = tswin.swin_features(tcfg, tp_full, torch.from_numpy(x))
    assert float((full - got).abs().max()) > 1e-3


def test_feature_extractor_matches_jax_and_vmaps():
    """The GA's extractor: (x + 1) / 2, ImageNet normalisation, features
    averaged over H', W'; and ``torch.func.vmap`` of it over candidates
    equals the plain call on the flattened batch."""
    jcfg, jp, tcfg, tp = pair(28, seed=5)
    x = np.random.RandomState(3).uniform(-1, 1, (6, 3, 28, 28)).astype(
        np.float32)
    want = jswin.make_feature_extractor(jcfg, jp)(jnp.asarray(x))
    extract = tswin.make_feature_extractor(tcfg, tp, device="cpu")
    got = extract(torch.from_numpy(x))
    assert tuple(got.shape) == (6, 48)
    _close(got, want)
    per = torch.func.vmap(extract)(torch.from_numpy(x).reshape(3, 2, 3, 28,
                                                                28))
    _close(per.reshape(6, 48), want)


def test_random_tower_has_the_swin_t_shape():
    cfg = tswin.swin_tiny_config()
    p = tswin.init_swin(torch.Generator().manual_seed(0), cfg)
    leaves = _leaves(p)
    n = sum(v.size for v in leaves.values())
    # Swin-T's backbone without the classifier and its final norm: ~27.5M.
    assert 27_000_000 < n < 28_500_000, n
    assert leaves["layers.2.blocks.5.fc1.weight"].shape == (1536, 384)
    assert leaves["layers.3.blocks.1.rel_bias"].shape == (169, 24)
