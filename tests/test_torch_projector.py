"""The port's LPIPS projector (gagan_tpu_torch/inversion/projector.py)
against the JAX package's, on the tiny generator of tests/test_inversion.py
(32^2, 8 W+ layers) with non-zero noise strengths, so that the noise
buffers take real gradients.  JAX's draws are injected (``JaxRng``): the
noise buffers' starting values and each step's latent noise are JAX's
numbers.

Both run 5 steps with the VGG16-LPIPS embedding (weights of
tests/test_torch_vgg16.py) and with the pixel stand-in of
tests/test_inversion.py.  Read from both: the gradients Adam is given (of
the latent and of each noise buffer) at the two steps taken from equal
states (step 0 has learning rate 0), the noise buffers as every step's loss
takes them (the state after steps 0..4) and the latent after every step
(the trajectory).

Tolerances: the gradients 1e-3 of their max (the suite's); the latent and
the noise buffers 1e-3 of their max plus 2% of the learning rate summed
over the steps taken.  That second term is Adam's: it moves every entry by
about lr * g / |g|, so an entry whose gradient is a thousandth of the
largest one carries the fp32 difference of the two packages' sums (a few
1e-6 of the max; the gradients agree to that) as a relative error of its
own step, and the next gradients are taken at states that differ by that.
A wrong gradient moves the states by O(lr) a step.  The noise penalty:
2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gagan_tpu.inversion import projector as jproj
from gagan_tpu.metrics import vgg16 as jvgg
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.inversion import projector as tproj
from gagan_tpu_torch.metrics import vgg16 as tvgg
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.ops.resize import resize2d
from gagan_tpu_torch.train.train_step import Adam
from gagan_tpu_torch.utils import checkpoint as tck
from .test_torch_augment import JaxRng
from .test_torch_vgg16 import vgg_flat

torch.set_num_threads(2)

STEPS = 5


@pytest.fixture(scope="module")
def tiny_g():
    jcfg = jsg.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=32, img_channels=3,
        mapping=jsg.MappingConfig(num_layers=2),
        synthesis=jsg.SynthesisConfig(channel_base=1024, channel_max=64))
    tcfg = tsg.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=32, img_channels=3,
        mapping=tsg.MappingConfig(num_layers=2),
        synthesis=tsg.SynthesisConfig(channel_base=1024, channel_max=64))
    flat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(3)
    flat = {k: (np.float32(rng.uniform(0.1, 0.4))
                if k.endswith("noise_strength") else v)
            for k, v in flat.items()}
    z = jax.random.normal(jax.random.PRNGKey(1), (1, 32))
    img = jsg.generator_apply(jcfg, jck.flat_to_tree(flat), z,
                              noise_mode="const")
    target = np.asarray(jnp.clip(img * 127.5 + 128, 0, 255)).astype(
        np.uint8)[0]
    return jcfg, tcfg, flat, target


def _lpips_fns(kind):
    if kind == "vgg16":
        flat = vgg_flat(1)
        jp, tp = jck.flat_to_tree(flat), tck.flat_to_tree(flat)
        return (lambda img: jvgg.vgg16_lpips(jp, img),
                lambda img: tvgg.vgg16_lpips(tp, img))

    def jpix(images):
        x = images.astype(jnp.float32) / 255.0
        x = jax.image.resize(x, x.shape[:2] + (16, 16), method="bilinear")
        return x.reshape(x.shape[0], -1)

    def tpix(images):
        x = resize2d(images.float() / 255.0, (16, 16), "bilinear")
        return x.reshape(x.shape[0], -1)

    return jpix, tpix


def _close(got, want, tol, slack=0.0, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max() + slack,
                               err_msg=err_msg)


def _lr(step, num_steps=STEPS):
    """The projector's learning rate at ``step`` (its defaults)."""
    t = step / num_steps
    ramp = 0.5 - 0.5 * np.cos(min(1.0, (1.0 - t) / 0.25) * np.pi)
    return 0.1 * ramp * min(1.0, t / 0.05)


@pytest.mark.parametrize("kind,space", [("vgg16", "w"), ("pixel", "w"),
                                        ("pixel", "z")])
def test_projector_steps_match_jax(tiny_g, monkeypatch, kind, space):
    jcfg, tcfg, flat, target = tiny_g
    jtree, ttree = jck.flat_to_tree(flat), tck.flat_to_tree(flat)
    assert list(jproj._collect_noise_bufs(jtree["synthesis"])) == list(
        tproj.collect_noise_bufs(ttree["synthesis"]))
    jfn, tfn = _lpips_fns(kind)

    # What each step's loss takes and what Adam is given, from both.
    jseen, tseen, jgrads, tgrads = [], [], [], []
    jreg, treg = jproj.noise_regularization, tproj.noise_regularization

    def jrecord(bufs):
        jax.debug.callback(lambda b: jseen.append(
            {k: np.asarray(v) for k, v in b.items()}), bufs, ordered=True)
        return jreg(bufs)

    def trecord(bufs):
        tseen.append({k: v.detach().clone().numpy() for k, v in bufs.items()})
        return treg(bufs)

    class JaxAdam:
        """optax with an adam whose update records its gradients."""

        def __getattr__(self, name):
            return getattr(optax, name)

        @staticmethod
        def adam(*args, **kw):
            inner = optax.adam(*args, **kw)

            def update(g, state, params=None):
                jax.debug.callback(lambda g: jgrads.append(
                    {k: np.asarray(v) for k, v in jck.tree_to_flat(g).items()}
                ), g, ordered=True)
                return inner.update(g, state, params)

            return optax.GradientTransformation(inner.init, update)

    monkeypatch.setattr(jproj, "noise_regularization", jrecord)
    monkeypatch.setattr(tproj, "noise_regularization", trecord)
    monkeypatch.setattr(jproj, "optax", JaxAdam())
    key = jax.random.PRNGKey(2)
    kw = dict(num_steps=STEPS, w_avg_samples=64, space=space,
              return_trajectory=True)
    jtraj, jfinal = jproj.project(jcfg, jtree, target, lpips_fn=jfn, key=key,
                                  **kw)
    dists = []

    def on_step(step, dist, grads):
        dists.append(dist)
        tgrads.append({k: v.numpy() for k, v in grads.items()})

    ttraj, tfinal = tproj.project(tcfg, ttree, target, lpips_fn=tfn,
                                  rng=JaxRng(key), on_step=on_step, **kw)
    assert ttraj.shape == jtraj.shape == (STEPS, 32)
    assert tfinal.shape == jfinal.shape == (tcfg.num_ws, 32)
    assert len(jseen) == len(tseen) == len(jgrads) == len(tgrads) == STEPS
    lr_sum = np.cumsum([_lr(step) for step in range(STEPS)])
    for step in range(STEPS):
        assert sorted(tgrads[step]) == sorted(jgrads[step])
        if _lr(step - 1) == 0.0:
            # Equal states (step 0 takes lr 0): equal gradients.
            for k, want in jgrads[step].items():
                _close(tgrads[step][k], want, 1e-3, err_msg=f"d{k} at {step}")
        # The state the step's loss took: after `step` updates.
        slack = 0.02 * (lr_sum[step - 1] if step else 0.0)
        assert sorted(tseen[step]) == sorted(jseen[step])
        for k, want in jseen[step].items():
            _close(tseen[step][k], want, 1e-3, slack, f"{k} at {step}")
        _close(ttraj[step], jtraj[step], 1e-3, 0.02 * lr_sum[step],
               f"latent after {step}")
    _close(tfinal, jfinal, 1e-3, 0.02 * lr_sum[-1], "final")
    # d(noise) reached the buffers: they moved by more than the
    # renormalisation.
    assert max(np.abs(tseen[-1][k] - tseen[1][k]).max()
               for k in tseen[1]) > 1e-3
    assert len(dists) == STEPS and all(
        bool(torch.isfinite(d)) for d in dists)


def test_noise_regularization_matches_jax():
    rng = np.random.RandomState(4)
    bufs = {"b4.conv1": rng.randn(4, 4), "b8.conv0": rng.randn(8, 8),
            "b32.conv1": rng.randn(32, 32) + 0.3,
            "b64.conv1": np.cumsum(rng.randn(64, 64), axis=1)}
    bufs = {k: v.astype(np.float32) for k, v in bufs.items()}
    want = jproj.noise_regularization({k: jnp.asarray(v)
                                       for k, v in bufs.items()})
    got = tproj.noise_regularization({k: torch.from_numpy(v)
                                      for k, v in bufs.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)


@pytest.mark.parametrize("res", [128, 256, 512, 1024])
def test_area_resize_matches_jax(res):
    img = np.random.RandomState(5).uniform(0, 255, (1, 3, res, res)).astype(
        np.float32)
    want = jproj._area_resize_256(jnp.asarray(img))
    got = tproj._area_resize_256(torch.from_numpy(img))
    assert tuple(got.shape) == want.shape
    _close(got, want, 2e-4)


def test_adam_update_equals_optax():
    """The projector's update: Adam at lr 1 (eps outside the square root)
    scaled by the step's lr, as optax.adam(1.0) followed by * lr."""
    rng = np.random.RandomState(6)
    p = {"latent": rng.randn(1, 8).astype(np.float32),
         "noise": {"b4.conv1": rng.randn(4, 4).astype(np.float32)}}
    tx = optax.adam(1.0, b1=0.9, b2=0.999)
    jp, state = jax.tree.map(jnp.asarray, p), tx.init(p)
    tp = {"latent": torch.from_numpy(p["latent"].copy()),
          "noise": {"b4.conv1": torch.from_numpy(p["noise"]["b4.conv1"]
                                                 .copy())}}
    ttx = Adam(1.0, 0.9, 0.999, 1e-8)
    tstate = ttx.init(tp)
    for lr in (0.0, 0.03, 0.1):
        g = {"latent": rng.randn(1, 8).astype(np.float32),
             "noise": {"b4.conv1": rng.randn(4, 4).astype(np.float32)}}
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * lr, upd))
        Adam(lr, 0.9, 0.999, 1e-8).update_(
            {k: torch.from_numpy(v) for k, v in tck.tree_to_flat(g).items()},
            tstate, tp)
        for k, v in jck.tree_to_flat(jp).items():
            np.testing.assert_allclose(tck.tree_to_flat(tp)[k], v, rtol=1e-6,
                                       atol=1e-6, err_msg=k)
