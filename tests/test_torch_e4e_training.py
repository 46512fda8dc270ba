"""The port's e4e latent adversary (gagan_tpu_torch/inversion/e4e_training.py)
against the JAX package's: the discriminator's init with JAX's draws
injected (``JaxRng``: equal), its forward, the three losses and R1 (2e-4 of
max|JAX|, the suite's forward tolerance), the gradients of the D loss with
R1 in D's parameters (1e-3, the suite's gradient tolerance), and the
replay pool, whose numpy stream crosses frameworks as it is (equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.inversion import e4e_training as je4e
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.inversion import e4e_training as te4e
from gagan_tpu_torch.utils import checkpoint as tck

from .test_torch_augment import JaxRng

torch.set_num_threads(2)


def _close(got, want, tol=2e-4):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6))


@pytest.fixture(scope="module")
def discs():
    key = jax.random.PRNGKey(0)
    jp = je4e.init_latent_discriminator(key, style_dim=64, n_mlp=4)
    tp = te4e.init_latent_discriminator(JaxRng(key), style_dim=64, n_mlp=4)
    flat = jck.tree_to_flat(jp)
    got = tck.tree_to_flat(tp)
    assert sorted(got) == sorted(flat) == [
        f"mlp.{i}.{p}" for i in (0, 2, 4, 6) for p in ("bias", "weight")]
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    # Non-zero biases, so that they do work in the checks below.
    rng = np.random.RandomState(1)
    flat = {k: (rng.randn(*np.shape(v)).astype(np.float32) * 0.1
                if k.endswith("bias") else np.asarray(v))
            for k, v in flat.items()}
    return _layers(flat, jnp.asarray), _layers(flat, torch.from_numpy)


def _layers(flat, to):
    """{"mlp.<i>": {"weight", "bias"}}: the layer names keep their dot."""
    out = {}
    for k, v in flat.items():
        name, leaf = k.rsplit(".", 1)
        out.setdefault(name, {})[leaf] = to(v)
    return out


@pytest.mark.parametrize("shape", [(5, 64), (3, 4, 64)])
def test_discriminator_and_losses_match_jax(discs, shape):
    jp, tp = discs
    rng = np.random.RandomState(2)
    real = rng.randn(*shape).astype(np.float32) * 2
    fake = rng.randn(*shape).astype(np.float32) * 2
    jr = je4e.latent_discriminator_apply(jp, jnp.asarray(real))
    jf = je4e.latent_discriminator_apply(jp, jnp.asarray(fake))
    tr = te4e.latent_discriminator_apply(tp, torch.from_numpy(real))
    tf = te4e.latent_discriminator_apply(tp, torch.from_numpy(fake))
    assert tuple(tr.shape) == shape[:-1] + (1,)
    _close(tr, jr)
    _close(tf, jf)
    _close(te4e.d_logistic_loss(tr, tf), je4e.d_logistic_loss(jr, jf))
    _close(te4e.g_nonsaturating_loss(tf), je4e.g_nonsaturating_loss(jf))
    _close(te4e.d_r1_loss(tp, torch.from_numpy(real)),
           je4e.d_r1_loss(jp, jnp.asarray(real)))


def test_r1_gradients_match_jax(discs):
    """d/dD of the D loss plus R1: R1's gradient needs the double
    backward (``create_graph``)."""
    jp, tp = discs
    rng = np.random.RandomState(3)
    real = rng.randn(6, 64).astype(np.float32)
    fake = rng.randn(6, 64).astype(np.float32)

    def jloss(p):
        return (je4e.d_logistic_loss(
            je4e.latent_discriminator_apply(p, jnp.asarray(real)),
            je4e.latent_discriminator_apply(p, jnp.asarray(fake)))
            + 5.0 * je4e.d_r1_loss(p, jnp.asarray(real)))

    want = jck.tree_to_flat(jax.grad(jloss)(jp))
    leaves = {f"{n}.{k}": v for n, layer in tp.items()
              for k, v in layer.items()}
    for v in leaves.values():
        v.requires_grad_(True)
    loss = (te4e.d_logistic_loss(
        te4e.latent_discriminator_apply(tp, torch.from_numpy(real)),
        te4e.latent_discriminator_apply(tp, torch.from_numpy(fake)))
        + 5.0 * te4e.d_r1_loss(tp, torch.from_numpy(real)))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for v in leaves.values():
        v.requires_grad_(False)
    for (k, v), g in zip(leaves.items(), grads):
        _close(g, want[k], 1e-3)


@pytest.mark.parametrize("pool_size", [0, 3, 50])
def test_latent_codes_pool_equals_jax(pool_size):
    jpool = je4e.LatentCodesPool(pool_size, seed=4)
    tpool = te4e.LatentCodesPool(pool_size, seed=4)
    rng = np.random.RandomState(5)
    for i in range(8):
        ws = rng.randn(4, 18, 16).astype(np.float32) if i % 2 else \
            rng.randn(4, 16).astype(np.float32)
        want = jpool.query(ws)
        got = tpool.query(torch.from_numpy(ws) if i % 3 == 0 else ws)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert len(tpool.ws) == len(jpool.ws) == min(pool_size, 32)
