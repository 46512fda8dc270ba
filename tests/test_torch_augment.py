"""The port's ADA pipe (gagan_tpu_torch.train.augment) against the JAX
package's eager ``augment_pipe(geom_mode="exact")``, on the same images,
with JAX's own draws injected: :class:`JaxRng` hands the port the numbers
that ``jax.random`` gives for the same key tree (the other port tests
import it).

Tolerances: 2e-4 of max|.| in float32 (the JAX suite's forward tolerance:
summation order in the wavelet convolutions and the resample); gradients
1e-3 of max|.| (the suite's gradient tolerance).  In bfloat16 both sides
round the same tensors, so values may land one bf16 rounding apart and
pass it through later steps: 2^-6 of max|.|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.train import augment as jaug
from gagan_tpu_torch.train import augment as taug
from gagan_tpu_torch.utils import rng as trng

torch.set_num_threads(2)


class JaxRng:
    """The port's draw-source interface backed by jax.random: the draws are
    JAX's numbers for the same key tree, as float32 / int64 torch tensors."""

    def __init__(self, key):
        self.key = key

    def split(self, n):
        return [JaxRng(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, data):
        return JaxRng(jax.random.fold_in(self.key, data))

    def normal(self, shape, device="cpu"):
        return torch.from_numpy(np.array(jax.random.normal(
            self.key, tuple(shape)))).to(device)

    def uniform(self, shape, device="cpu"):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.key, tuple(shape)))).to(device)

    def randint(self, shape, low, high, device="cpu"):
        return torch.from_numpy(np.array(jax.random.randint(
            self.key, tuple(shape), low, high)).astype(np.int64)).to(device)


def _images(seed=0, n=4, res=32):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, 3, res, res)).astype(np.float32)


def _run_both(spec, p, seed=0, **cfg_kw):
    jcfg = dataclasses.replace(jaug.make_config(spec), geom_mode="exact",
                               **cfg_kw)
    tcfg = dataclasses.replace(taug.make_config(spec), geom_mode="exact",
                               **cfg_kw)
    img = _images(seed)
    key = jax.random.PRNGKey(seed + 10)
    dt = jnp.bfloat16 if cfg_kw.get("compute_dtype") else jnp.float32
    want = jaug.augment_pipe(jcfg, jnp.asarray(img), p, key)
    got = taug.augment_pipe(tcfg, torch.from_numpy(img), p, JaxRng(key))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    return got.numpy(), np.asarray(want), dt


def _close(got, want, rel):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


# Specs that need more than the JAX pipe's 32 keys: JAX stops with
# StopIteration, the port draws on from 32 more keys.
_OVER_32_DRAWS = ("bgcf", "bgcfn", "bgcfnc")


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("spec", sorted(taug.AUGPIPE_SPECS))
def test_augment_matches_jax(spec, p):
    if spec in _OVER_32_DRAWS:
        with pytest.raises(StopIteration):
            _run_both(spec, p)
        img = torch.from_numpy(_images(0))
        got = taug.augment_pipe(taug.make_config(spec), img, p,
                                JaxRng(jax.random.PRNGKey(10)))
        assert got.shape == img.shape and bool(torch.isfinite(got).all())
        return
    got, want, _ = _run_both(spec, p)
    _close(got, want, 2e-4)
    if p == 0.0 and spec != "noise":
        # Every gate is shut: the pipe is the identity up to resampling.
        _close(got, _images(0), 2e-3)


def test_augment_bf16_matches_jax():
    got, want, _ = _run_both("bgc", 1.0, seed=3, compute_dtype="bfloat16")
    _close(got, want, 2.0 ** -6)


@pytest.mark.parametrize("spec,q", [("bgc", 0.1), ("bgc", 0.7),
                                    ("filter", 0.3), ("noise", 0.6),
                                    ("cutout", 0.4)])
def test_debug_percentile_matches_jax(spec, q):
    img = _images(5)
    cfg = dataclasses.replace(taug.make_config(spec), geom_mode="exact")
    jcfg = dataclasses.replace(jaug.make_config(spec), geom_mode="exact")
    key = jax.random.PRNGKey(2)
    want = jaug.augment_pipe(jcfg, jnp.asarray(img), 1.0, key,
                             debug_percentile=q)
    got = taug.augment_pipe(cfg, torch.from_numpy(img), 1.0, JaxRng(key),
                            debug_percentile=q)
    _close(got.numpy(), np.asarray(want), 2e-4)


@pytest.mark.parametrize("spec", ["bgc", "filter", "noise", "cutout"])
def test_augment_gradients_match_jax(spec):
    """The image gradient of sum(w * aug(x)^2) and the gradient of that
    gradient's squared norm (the R1 shape: a double backward through the
    pipe, the gathers of the resample included)."""
    img = _images(7)
    wts = np.random.RandomState(8).randn(*img.shape).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jcfg = dataclasses.replace(jaug.make_config(spec), geom_mode="exact")
    tcfg = dataclasses.replace(taug.make_config(spec), geom_mode="exact")

    def jf(x):
        return jnp.sum(wts * jaug.augment_pipe(jcfg, x, 1.0, key) ** 2)

    def jh(x):
        return jnp.sum(jax.grad(jf)(x) ** 2)

    jg = np.asarray(jax.grad(jf)(jnp.asarray(img)))
    jgg = np.asarray(jax.grad(jh)(jnp.asarray(img)))

    x = torch.from_numpy(img).requires_grad_()
    out = (torch.from_numpy(wts)
           * taug.augment_pipe(tcfg, x, 1.0, JaxRng(key)) ** 2).sum()
    (g,) = torch.autograd.grad(out, x, create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), x)
    _close(g.detach().numpy(), jg, 1e-3)
    _close(gg.numpy(), jgg, 1e-3)


def test_torch_rng_is_a_key_tree():
    """The default draw source: a key drawn from twice gives the same
    numbers, split and fold_in give other ones, and it draws on the device
    asked for."""
    k = trng.Rng(3)
    a, b = k.split(2)
    assert torch.equal(a.normal((5,)), a.normal((5,)))
    assert not torch.equal(a.normal((5,)), b.normal((5,)))
    assert not torch.equal(k.fold_in(1).uniform((5,)),
                           k.fold_in(2).uniform((5,)))
    assert torch.equal(trng.Rng(3).split(2)[1].uniform((4,)), b.uniform((4,)))
    r = k.randint((100,), 1, 7)
    assert r.dtype == torch.int64 and int(r.min()) >= 1 and int(r.max()) < 7
    assert trng.name_fold("b8.conv1") == (
        __import__("zlib").crc32(b"b8.conv1") % 2 ** 31)


def test_default_pipe_runs_and_fast_mode_raises():
    """The default pipe runs; "fast" now runs too (it raised before the
    warp was ported), and an unknown mode raises.  "auto" is "exact" in a
    direct call and "fast" through make_augment_fn (the train step's)."""
    img = torch.from_numpy(_images(11))
    out = taug.augment_pipe(taug.make_config("bgcfnc"), img, 0.7,
                            trng.Rng(0))
    assert out.shape == img.shape and bool(torch.isfinite(out).all())
    cfg = dataclasses.replace(taug.make_config("bg"), geom_mode="fast")
    fast = taug.augment_pipe(cfg, img, 0.5, trng.Rng(0))
    assert fast.shape == img.shape and bool(torch.isfinite(fast).all())
    auto = taug.make_config("bg")
    torch.testing.assert_close(
        taug.make_augment_fn(auto)(img, 0.5, trng.Rng(0)), fast,
        rtol=0, atol=0)
    exact = dataclasses.replace(auto, geom_mode="exact")
    torch.testing.assert_close(
        taug.augment_pipe(auto, img, 0.5, trng.Rng(0)),
        taug.augment_pipe(exact, img, 0.5, trng.Rng(0)), rtol=0, atol=0)
    with pytest.raises(ValueError, match="geom_mode"):
        taug.augment_pipe(dataclasses.replace(auto, geom_mode="warp"), img,
                          0.5, trng.Rng(0))


def test_filter_bank_matches_jax():
    np.testing.assert_array_equal(taug._filter_bank(), jaug._HZ_FBANK)
