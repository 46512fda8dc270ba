"""The port's image and math utilities and ``merge_hooks`` against the JAX
package on the CPU, on the same seeded numpy inputs.

Tolerances: the bicubic downsample and its gradient within the suite's
2e-4 (1e-3 of max|grad| for the gradient); the resizes of ``t2im`` and
the paper grid are held in uint8 to one level (JAX's resize and torch's
antialiased bilinear weigh the same triangle and round differently in the
last float bit, which moves a value across a .5 now and then), with at
most 0.5% of the pixels a level apart; the samplers within 1e-5 (their
draws are JAX's, handed in through ``JaxRng``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.parallel.spatial import merge_hooks as jmerge
from gagan_tpu.utils import image_utils as jiu
from gagan_tpu.utils import math_utils as jmu
from gagan_tpu_torch.parallel import spatial as tspatial
from gagan_tpu_torch.parallel import merge_hooks as tmerge
from gagan_tpu_torch.utils import image_utils as tiu
from gagan_tpu_torch.utils import math_utils as tmu
from .test_torch_augment import JaxRng

torch.set_num_threads(2)


def _img(shape, seed=0, scale=1.2):
    return (np.random.RandomState(seed).uniform(-scale, scale, shape)
            .astype(np.float32))


@pytest.mark.parametrize("factor,clip_round", [(2, False), (4, False),
                                               (4, True)])
def test_bicubic_downsample_matches_jax(factor, clip_round):
    x = _img((2, 3, 32, 32), factor)
    if clip_round:
        x = (x + 1.2) * 100
    want = np.asarray(jiu.bicubic_downsample(jnp.asarray(x), factor,
                                             clip_round))
    got = tiu.bicubic_downsample(torch.from_numpy(x), factor, clip_round)
    assert tuple(got.shape) == want.shape == (2, 3, 32 // factor, 32 // factor)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


def test_bicubic_downsample_gradient_matches_jax():
    x = _img((2, 3, 32, 32), 5)
    r = _img((2, 3, 8, 8), 6)
    want = np.asarray(jax.grad(lambda x: jnp.sum(
        jiu.bicubic_downsample(x, 4) * r))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    (tiu.bicubic_downsample(tx, 4) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())


def _uint8_close(got, want):
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.005


@pytest.mark.parametrize("shape,size", [((3, 32, 32), 16), ((3, 32, 32), 64),
                                        ((3, 24, 40), 12), ((3, 40, 24), 30)])
def test_t2im_matches_jax(shape, size):
    img = _img(shape, size)
    got = tiu.t2im(torch.from_numpy(img), size)
    _uint8_close(got, jiu.t2im(jnp.asarray(img), size))
    assert min(got.shape[:2]) == size


@pytest.mark.parametrize("size", [64, 128])
def test_resize_img_takes_half_pixel_centres(size):
    """Nearest at the grid's exact /2 and /4, as jax.image.resize picks."""
    img = _img((3, size, size), 7)
    for out in (size // 2, size // 4):
        want = np.asarray(jiu.resize_img(jnp.asarray(img), out))
        got = tiu.resize_img(torch.from_numpy(img), out).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("res", [64, 256])
def test_paper_grid_matches_jax(res):
    imgs = _img((16, 3, res, res), res)
    got = tiu.construct_paper_image_grid(torch.from_numpy(imgs))
    want = jiu.construct_paper_image_grid(jnp.asarray(imgs))
    _uint8_close(got, want)
    assert got.shape[0] == 512
    with pytest.raises(ValueError, match="16"):
        tiu.construct_paper_image_grid(torch.from_numpy(imgs[:4]))


def test_crop_augmentation_with_injected_offsets():
    img = _img((2, 3, 64, 64), 8)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jiu.crop_augmentation(key, jnp.asarray(img), size=64))
    got = tiu.crop_augmentation(torch.from_numpy(img), size=64,
                                rng=JaxRng(key))
    np.testing.assert_array_equal(got.numpy(), want)
    x, y = (int(v) for v in jax.random.randint(key, (2,), 0, 12))
    got = tiu.crop_augmentation(torch.from_numpy(img), size=64,
                                offsets=(x, y))
    np.testing.assert_array_equal(got.numpy(), want)
    # Drawn from a torch.Generator: 51^2, offsets in [0, 12).
    a = tiu.crop_augmentation(torch.from_numpy(img), size=64,
                              rng=torch.Generator().manual_seed(1))
    b = tiu.crop_augmentation(torch.from_numpy(img), size=64,
                              rng=torch.Generator().manual_seed(1))
    assert tuple(a.shape) == (2, 3, 51, 51) and torch.equal(a, b)


@pytest.mark.parametrize("fn,shape", [
    ("resample_single_vector", (16,)),
    ("resample_batch_vectors", (5, 16)),
    ("resample_batch_templated_embeddings", (3, 4, 16)),
    ("resample_batch_templated_embeddings", (5, 16)),
])
def test_samplers_match_jax_on_its_draws(fn, shape):
    v = _img(shape, 9)
    key = jax.random.PRNGKey(11)
    kw = {"n_vectors": 6} if fn == "resample_single_vector" else {}
    want = np.asarray(getattr(jmu, fn)(key, jnp.asarray(v), 0.8, **kw))
    got = getattr(tmu, fn)(JaxRng(key), torch.from_numpy(v), 0.8, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # Unit vectors within the cosine bound of their targets.
    u = torch.from_numpy(v).reshape(-1, 16)
    u = u / u.norm(dim=1, keepdim=True)
    g = got.reshape(-1, 16)
    assert torch.allclose(g.norm(dim=1), torch.ones(len(g)), atol=1e-5)
    assert bool(((g * u).sum(1) >= 0.8 - 1e-5).all())


def test_convex_hulls_match_jax():
    v3, v2 = _img((4, 3, 16), 12), _img((4, 16), 13)
    a = np.abs(_img((5, 4), 14))
    np.testing.assert_allclose(
        tmu.convex_hull(torch.from_numpy(v3), torch.from_numpy(a)).numpy(),
        np.asarray(jmu.convex_hull(jnp.asarray(v3), jnp.asarray(a))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tmu.convex_hull_small(torch.from_numpy(v2), torch.from_numpy(a)).numpy(),
        np.asarray(jmu.convex_hull_small(jnp.asarray(v2), jnp.asarray(a))),
        rtol=1e-5, atol=1e-6)


def test_merge_hooks_runs_base_first_then_extra():
    """Where both trees hold a slot, base runs first and extra wraps it;
    other slots pass through; an empty base gives extra itself."""
    for merge in (jmerge, tmerge):
        calls = []

        def tag(name, f):
            return lambda v: calls.append(name) or f(v)

        base = {"b8.conv0": {"style": tag("base", lambda v: v * 2)},
                "b8.conv1": {"w": tag("base_w", lambda v: v + 1)}}
        extra = {"b8.conv0": {"style": tag("extra", lambda v: v + 3)},
                 "b16.conv0": {"weight": tag("extra_w", lambda v: -v)}}
        m = merge(base, extra)
        assert m["b8.conv0"]["style"](1.0) == 5.0       # (1 * 2) + 3
        assert calls == ["base", "extra"]
        assert m["b8.conv1"]["w"](1.0) == 2.0
        assert m["b16.conv0"]["weight"](1.0) == -1.0
        assert merge(None, extra) is extra and merge({}, extra) is extra
        assert base["b8.conv0"]["style"](1.0) == 2.0          # not mutated
    # spatial_sharding_hooks, refused while the port ran on one device,
    # now gives JAX's keys; their "post" slot keeps its layout through
    # merge_hooks in either order.
    from gagan_tpu.models import stylegan2 as jsg
    from gagan_tpu.parallel import create_mesh
    from gagan_tpu.parallel.spatial import spatial_sharding_hooks as jhooks
    from gagan_tpu_torch.models import stylegan2 as tsg
    from gagan_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.Mesh(2, 0, torch.device("cpu"), "gloo", object())
    hooks = tspatial.spatial_sharding_hooks(
        tsg.SynthesisConfig(img_resolution=64), mesh, min_res=16)
    assert set(hooks) == set(jhooks(jsg.SynthesisConfig(img_resolution=64),
                                    create_mesh(2), min_res=16))
    post = {"b64.conv1": {"post": lambda v: v + 1}}
    for m in (tmerge(hooks, post), tmerge(post, hooks)):
        assert m["b64.conv1"]["post"].row_layout.world_size == 2
        assert m["b64.conv1"]["post"](1.0) == 2.0
