"""The port's II2S inversion (gagan_tpu_torch/inversion/ii2s.py) against
the JAX package's, with JAX's draws injected (``JaxRng``): the PCA's
latents and the w_avg estimate come from the same key tree on both sides.

The PCA is an SVD of the mapped samples: components whose singular values
nearly tie may rotate between the two SVDs, so the model is compared by
its mean, its standard deviations and the p-norm loss it gives (rtol
1e-4), not component by component.  The inversion runs the tiny G of
tests/test_styleflow_ii2s.py with its pixel "LPIPS" for 5 Adam steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.inversion import ii2s as jii
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch.inversion import ii2s as tii
from gagan_tpu_torch.ops.resize import resize2d
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils.config import generator_config_from_dict

from .test_torch_augment import JaxRng

torch.set_num_threads(2)


def test_leaky5_and_bicubic_256_match_jax():
    x = np.random.RandomState(0).randn(2, 3, 64, 48).astype(np.float32)
    np.testing.assert_array_equal(tii.leaky5(torch.from_numpy(x)).numpy(),
                                  np.asarray(jii.leaky5(jnp.asarray(x))))
    img = np.random.RandomState(1).uniform(-1, 1, (1, 3, 512, 512)).astype(
        np.float32)
    want = np.asarray(jii.bicubic_256(jnp.asarray(img)))
    got = tii.bicubic_256(torch.from_numpy(img)).numpy()
    assert got.shape == (1, 3, 256, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    small = torch.from_numpy(img[:, :, :256, :256].copy())
    assert tii.bicubic_256(small) is small


def _g_cfgs():
    jg = jsg.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=32, img_channels=3,
        mapping=jsg.MappingConfig(num_layers=2),
        synthesis=jsg.SynthesisConfig(channel_base=1024, channel_max=64))
    return jg, generator_config_from_dict(jconfig.to_dict(jg))


@pytest.fixture(scope="module")
def g():
    jg, tg = _g_cfgs()
    flat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0), jg))
    return jg, tg, jck.flat_to_tree(flat), tck.flat_to_tree(flat)


def test_build_pca_model_matches_jax(g):
    jg, tg, jp, tp = g
    key = jax.random.PRNGKey(3)
    want = jii.build_pca_model(jg, jp, key, n_samples=700, batch=256)
    got = tii.build_pca_model(tg, tp, JaxRng(key), n_samples=700, batch=256)
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()} == {
        "X_mean": (32,), "X_comp": (32, 32), "X_stdev": (32,)}
    for k in ("X_mean", "X_stdev"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max())
    lat = np.random.RandomState(4).randn(1, 8, 32).astype(np.float32)
    for lam in (1e-3, 1.0):
        w = float(jii.p_norm_loss(want, jnp.asarray(lat), lam))
        t = float(tii.p_norm_loss(got, torch.from_numpy(lat), lam))
        np.testing.assert_allclose(t, w, rtol=1e-4)
        # The same model on both sides: the loss's arithmetic alone.
        t = float(tii.p_norm_loss(want, torch.from_numpy(lat), lam))
        np.testing.assert_allclose(t, w, rtol=1e-5)


def _pixel_lpips_jax(images):
    x = images.astype(jnp.float32) / 255.0
    x = jax.image.resize(x, x.shape[:2] + (8, 8), method="bilinear")
    return x.reshape(x.shape[0], -1)


def _pixel_lpips_torch(images):
    x = resize2d(images.float() / 255.0, (8, 8), "bilinear")
    return x.reshape(x.shape[0], -1)


def test_invert_image_matches_jax(g):
    """5 steps at lr 0.05 from the w_avg estimate (JAX's init leaves w_avg
    at zero).  Adam's first steps move each coordinate by about lr whatever
    its gradient's size, so the latents are compared against the distance
    they moved: the two runs agree to 1e-4 of it (float32 sums in another
    order give gradients ~1e-6 apart, which Adam's normalisation keeps
    relative)."""
    jg, tg, jp, tp = g
    z = jax.random.normal(jax.random.PRNGKey(1), (1, 32))
    target = np.asarray(jsg.generator_apply(jg, jp, z, noise_mode="const"))[0]
    key = jax.random.PRNGKey(2)
    jcfg = jii.II2SConfig(steps=5, learning_rate=0.05, p_norm_lambda=1e-4,
                          pca_samples=512)
    tcfg = tii.II2SConfig(steps=5, learning_rate=0.05, p_norm_lambda=1e-4,
                          pca_samples=512)
    want = jii.invert_image(jcfg, jg, jp, target, lpips_fn=_pixel_lpips_jax,
                            key=key)
    got = tii.invert_image(tcfg, tg, tp, target, lpips_fn=_pixel_lpips_torch,
                           rng=JaxRng(key))
    assert got.shape == want.shape == (8, 32) and got.dtype == np.float32
    start = tii.initial_latent(tg, tp, JaxRng(key))[0].numpy()
    moved = np.abs(want - start).max()
    assert moved > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * moved)


def test_reference_fault_ii2s_caps_pca_samples(g, monkeypatch):
    """``invert_image`` fits its PCA on ``min(cfg.pca_samples, 100_000)``
    samples (gagan_tpu/inversion/ii2s.py:92-93), where the reference fits
    1M (II2S.py:87-105): a config asking for 1M gets 100,000 in JAX, and in
    the port, which reproduces it."""
    jg, tg, jp, tp = g
    asked = {}

    def recorder(name, fn):
        def build(*a, n_samples, **k):
            asked[name] = n_samples
            return fn(*a, n_samples=min(n_samples, 300), **k)
        return build

    monkeypatch.setattr(jii, "build_pca_model",
                        recorder("jax", jii.build_pca_model))
    monkeypatch.setattr(tii, "build_pca_model",
                        recorder("port", tii.build_pca_model))
    target = np.zeros((3, 32, 32), np.float32)
    key = jax.random.PRNGKey(5)
    jii.invert_image(jii.II2SConfig(steps=0, pca_samples=1_000_000), jg, jp,
                     target, lpips_fn=_pixel_lpips_jax, key=key)
    tii.invert_image(tii.II2SConfig(steps=0, pca_samples=1_000_000), tg, tp,
                     target, lpips_fn=_pixel_lpips_torch, rng=JaxRng(key))
    assert asked == {"jax": 100_000, "port": 100_000}
