"""The port's native-resolution warp (gagan_tpu_torch.train.warp) and the
ADA pipe's "fast" branch, against the JAX package's, on the CPU.

The warp alone runs over ``tests/test_warp.py``'s nine transforms with and
without antialias; the pipe runs at p = 1 under ``jax.jit`` (where the JAX
module takes its fast warp) with JAX's draws injected through ``JaxRng``.

Tolerances.  fp32: 1e-4 absolute on images of magnitude ~3 (pipe: ~1), i.e.
~3e-5 relative.  Both sides evaluate the same lerp and triangle weights in
fp32 from the same f32 coefficient arithmetic; they differ in summation
order (JAX contracts a dense one-hot matrix, the port sums the band's taps)
and in the last bits of the sampled positions, which the observed gap of
~2e-5 reflects; a wrong tap or weight moves a pixel by ~1e-1.  Gradients:
1e-3 of max|grad| (the JAX suite's).  bf16: the port rounds the lerp weight,
the shifted rows, the resample weights and the result to bf16 where JAX
does, so the two differ by the order of fp32 sums before a bf16 rounding:
at most 2 bf16 ulps of the largest output (2 * 2^-7 * max|y|), where a
wrong tap moves a pixel by ~2^-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.train import augment as jaug
from gagan_tpu.train import warp as jwarp
from gagan_tpu_torch.train import augment as taug
from gagan_tpu_torch.train import warp as twarp

from .test_torch_augment import JaxRng
from .test_warp import CASES

ATOL = 1e-4


@pytest.fixture(scope="module")
def smooth_img():
    rng = np.random.RandomState(0)
    base = rng.randn(2, 3, 12, 12).astype(np.float32)
    return np.asarray(jax.image.resize(jnp.asarray(base), (2, 3, 96, 96),
                                       "cubic"))


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_warp_matches_jax(smooth_img, name, antialias):
    m = CASES[name]
    theta = np.stack([m, m])
    want = np.asarray(jwarp.affine_warp(jnp.asarray(smooth_img),
                                        jnp.asarray(theta), 96, 96,
                                        antialias=antialias))
    got = twarp.affine_warp(torch.from_numpy(smooth_img),
                            torch.from_numpy(theta), 96, 96,
                            antialias=antialias).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_warp_rectangular_matches_jax(smooth_img):
    """A non-square input computes both variants and picks per sample."""
    img = np.ascontiguousarray(smooth_img[:, :, :, :80])
    theta = np.stack([CASES["rot20"], CASES["rot90ish"]])
    want = np.asarray(jwarp.affine_warp(jnp.asarray(img), jnp.asarray(theta),
                                        64, 72, antialias=True))
    got = twarp.affine_warp(torch.from_numpy(img), torch.from_numpy(theta),
                            64, 72, antialias=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _images(seed=0, n=4, res=32):
    rng = np.random.RandomState(seed)
    base = rng.randn(n, 3, res // 4, res // 4).astype(np.float32)
    return np.asarray(jax.image.resize(jnp.asarray(base), (n, 3, res, res),
                                       "cubic"))


def _jit_pipe(cfg, p, key, dp=None):
    return jax.jit(lambda x: jaug.augment_pipe(cfg, x, p, key,
                                               debug_percentile=dp))


PIPES = {
    # name: (spec or AugmentConfig overrides, debug_percentile)
    "bgc": ("bgc", None),
    "rotate_near_90": (dict(rotate=1), 0.74),
    "zoom_out": (dict(scale=1), 0.02),
    "zoom_in": (dict(scale=1), 0.98),
}


def _cfgs(name, **kw):
    spec, dp = PIPES[name]
    if isinstance(spec, str):
        return jaug.make_config(spec, **kw), taug.make_config(spec, **kw), dp
    return (jaug.AugmentConfig(**spec, **kw), taug.AugmentConfig(**spec, **kw),
            dp)


@pytest.mark.parametrize("name", sorted(PIPES))
def test_fast_pipe_matches_jax_jit(name):
    """The port's "auto" through make_augment_fn (the train step's route)
    against JAX's "auto" under jax.jit: both take the fast warp."""
    jcfg, tcfg, dp = _cfgs(name)
    img = _images(1)
    key = jax.random.PRNGKey(7)
    want = np.asarray(_jit_pipe(jcfg, 1.0, key, dp)(jnp.asarray(img)))
    if dp is None:
        got = taug.make_augment_fn(tcfg)(torch.from_numpy(img), 1.0,
                                         JaxRng(key))
    else:
        got = taug.augment_pipe(dataclasses.replace(tcfg, geom_mode="fast"),
                                torch.from_numpy(img), 1.0, JaxRng(key),
                                debug_percentile=dp)
    assert np.abs(want - img).max() > 1e-2         # the pipe did something
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_fast_pipe_bf16_matches_jax_jit():
    """The training command's image dtype: bgc with compute_dtype bf16."""
    jcfg, tcfg, _ = _cfgs("bgc", compute_dtype="bfloat16")
    img = _images(2)
    key = jax.random.PRNGKey(3)
    want = np.asarray(_jit_pipe(jcfg, 1.0, key)(jnp.asarray(img)),
                      np.float32)
    got = taug.make_augment_fn(tcfg)(torch.from_numpy(img), 1.0,
                                     JaxRng(key)).float().numpy()
    ulp = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)


def test_fast_pipe_second_order_grad_matches_jax():
    """R1's shape: d/dx of v . d/dx sum(w * pipe(x)^2), JAX by jax.grad of
    the jitted pipe, the port by a double backward."""
    jcfg, tcfg, _ = _cfgs("bgc")
    img = _images(3, n=2)
    rng = np.random.RandomState(5)
    wts = rng.uniform(0.5, 1.5, img.shape).astype(np.float32)
    vec = rng.randn(*img.shape).astype(np.float32)
    key = jax.random.PRNGKey(11)
    pipe = _jit_pipe(jcfg, 1.0, key)

    def first(x):
        return jax.grad(lambda y: jnp.sum(wts * pipe(y) ** 2))(x)

    want = np.asarray(jax.grad(lambda x: jnp.sum(vec * first(x)))(
        jnp.asarray(img)))

    fn = taug.make_augment_fn(tcfg)
    x = torch.from_numpy(img).requires_grad_(True)
    (g,) = torch.autograd.grad(
        (torch.from_numpy(wts) * fn(x, 1.0, JaxRng(key)) ** 2).sum(), x,
        create_graph=True)
    (got,) = torch.autograd.grad((torch.from_numpy(vec) * g).sum(), x)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())
