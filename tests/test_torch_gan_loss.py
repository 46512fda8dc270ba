"""The port's losses (gagan_tpu_torch.train.gan_loss) and GA primitives
against the JAX package's, on the same weights (JAX's init, crossing as
numpy) and the same draws: the port gets JAX's numbers for JAX's key tree
through ``JaxRng`` (mixing cutoff and second z, layer noise, PL noise,
augment draws, GA draws).

Tiny configs: 32x32, channel_base 512 / channel_max 32, z/w 32, mapping 2
layers, batch 4, the ADA pipe "bgc" at p = 0.6, float32 throughout.
Tolerances: losses and metrics 1e-4 relative (2e-4 of the suite's forward
tolerance, less because they are means); gradients 1e-3 of each leaf's
max|.| (the JAX suite's).  The JAX side runs its augment pipe under
autodiff, where it takes the static full-width reflect margin; the port
takes the data-dependent one.  Both sample the same points: the margin only
moves where the padded image starts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.ga import crossover_mutation as jcm
from gagan_tpu.ga import refine as jrefine
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.train import augment as jaug
from gagan_tpu.train import gan_loss as jgl
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.ga import crossover_mutation as tcm
from gagan_tpu_torch.ga import refine as trefine
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.train import augment as taug
from gagan_tpu_torch.train import gan_loss as tgl
from gagan_tpu_torch.utils import checkpoint as tck

from .test_torch_augment import JaxRng

torch.set_num_threads(2)

RES, BATCH = 32, 4


def tiny_cfgs(m, res=RES):
    g = m.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=res,
        mapping=m.MappingConfig(num_layers=2),
        synthesis=m.SynthesisConfig(channel_base=512, channel_max=32))
    d = m.DiscriminatorConfig(img_resolution=res, channel_base=512,
                              channel_max=32, mbstd_group_size=2)
    return g, d


def tiny_weights(seed=0):
    """JAX init of G and D, with noise strengths and biases non-zero."""
    jg, jd = tiny_cfgs(jsg)
    g = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(seed), jg))
    d = jck.tree_to_flat(jsg.init_discriminator(jax.random.PRNGKey(seed + 1),
                                                jd))
    rng = np.random.RandomState(seed)
    for flat in (g, d):
        for k, v in flat.items():
            if k.endswith("noise_strength"):
                flat[k] = np.float32(rng.uniform(0.1, 0.3))
            elif k.endswith(".bias") and ".affine." not in k:
                flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return g, d


def tiny_batch(seed=0, n=BATCH):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, 3, RES, RES)).astype(np.float32),
            rng.randn(n, 32).astype(np.float32))


def augment_fns():
    jcfg = dataclasses.replace(jaug.make_config("bgc"), geom_mode="exact")
    return jaug.make_augment_fn(jcfg), taug.make_augment_fn(
        dataclasses.replace(taug.make_config("bgc"), geom_mode="exact"))


def torch_leaves(flat):
    tree = tck.flat_to_tree(flat)
    leaves = tck.tree_to_flat_tensors(tree)
    return tree, leaves


def check_grads(leaves, jgrads, rel=1e-3, only=None):
    jflat = jck.tree_to_flat(jgrads)
    checked = 0
    for k, t in leaves.items():
        if only is not None and k not in only:
            continue
        want = np.asarray(jflat[k], np.float32)
        got = (t.grad.numpy() if t.grad is not None
               else np.zeros_like(want))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=rel * max(np.abs(want).max(), 1e-12),
                                   err_msg=k)
        checked += 1
    assert checked > 0


def check_metrics(got, want, rel=1e-4):
    assert set(got) == set(want), (set(got), set(want))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=rel,
                                   atol=rel, err_msg=k)


def test_softplus_matches_jax():
    x = np.linspace(-30, 30, 101).astype(np.float32)
    np.testing.assert_allclose(tgl.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jgl.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_run_g_matches_jax(prob):
    """Mapping with mixing, then synthesis with random layer noise."""
    gflat, _ = tiny_weights()
    jg, _ = tiny_cfgs(jsg)
    tg, _ = tiny_cfgs(tsg)
    _, z = tiny_batch()
    key = jax.random.PRNGKey(3)
    want_img, want_ws = jgl.run_G(jg, jck.flat_to_tree(gflat), jnp.asarray(z),
                                  None, key, prob)
    with torch.no_grad():
        img, ws = tgl.run_G(tg, tck.flat_to_tree(gflat), torch.from_numpy(z),
                            None, JaxRng(key), prob)
    np.testing.assert_allclose(ws.numpy(), np.asarray(want_ws), rtol=2e-4,
                               atol=2e-4)
    m = float(np.abs(want_img).max())
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=0,
                               atol=2e-4 * m)


def test_g_main_loss_matches_jax():
    gflat, dflat = tiny_weights(1)
    (jg, jd), (tg, td) = tiny_cfgs(jsg), tiny_cfgs(tsg)
    _, z = tiny_batch(1)
    jaf, taf = augment_fns()
    key = jax.random.PRNGKey(4)
    lcfg = dict(style_mixing_prob=0.9)

    def jloss(gp):
        return jgl.g_main_loss(jgl.GANLossConfig(**lcfg), jg, jd, gp,
                               jck.flat_to_tree(dflat), jnp.asarray(z), None,
                               key, augment_fn=jaf, ada_p=0.6)

    (jl, jm), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jck.flat_to_tree(gflat))
    gtree, leaves = torch_leaves(gflat)
    for t in leaves.values():
        t.requires_grad_()
    loss, metrics = tgl.g_main_loss(
        tgl.GANLossConfig(**lcfg), tg, td, gtree, tck.flat_to_tree(dflat),
        torch.from_numpy(z), None, JaxRng(key), augment_fn=taf,
        ada_p=torch.tensor(0.6))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    check_metrics(metrics, jm)
    check_grads(leaves, jgrad)


def test_g_pl_loss_matches_jax():
    """Path length: one VJP through synthesis inside the loss, so the
    gradient is a double backward through the composed synthesis."""
    gflat, _ = tiny_weights(2)
    jg, _ = tiny_cfgs(jsg)
    tg, _ = tiny_cfgs(tsg)
    _, z = tiny_batch(2)
    key = jax.random.PRNGKey(5)

    def jloss(gp):
        return jgl.g_pl_loss(jgl.GANLossConfig(), jg, gp, jnp.asarray(z),
                             None, key, jnp.float32(0.5))

    (jl, jm), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jck.flat_to_tree(gflat))
    gtree, leaves = torch_leaves(gflat)
    for t in leaves.values():
        t.requires_grad_()
    loss, metrics = tgl.g_pl_loss(tgl.GANLossConfig(), tg, gtree,
                                  torch.from_numpy(z), None, JaxRng(key),
                                  torch.tensor(0.5))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    check_metrics(metrics, jm)
    check_grads(leaves, jgrad)


@pytest.mark.parametrize("ga", [None, 10.0])
def test_d_main_loss_matches_jax(ga):
    """Dmain, with the GA splice on (threshold 10: every fake replaced)."""
    gflat, dflat = tiny_weights(3)
    (jg, jd), (tg, td) = tiny_cfgs(jsg), tiny_cfgs(tsg)
    real, z = tiny_batch(3)
    jaf, taf = augment_fns()
    key = jax.random.PRNGKey(6)

    def jloss(dp):
        return jgl.d_main_loss(jgl.GANLossConfig(), jg, jd,
                               jck.flat_to_tree(gflat), dp, jnp.asarray(real),
                               None, jnp.asarray(z), None, key,
                               augment_fn=jaf, ada_p=0.6, ga_threshold=ga)

    (jl, jm), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jck.flat_to_tree(dflat))
    dtree, leaves = torch_leaves(dflat)
    for t in leaves.values():
        t.requires_grad_()
    loss, metrics = tgl.d_main_loss(
        tgl.GANLossConfig(), tg, td, tck.flat_to_tree(gflat), dtree,
        torch.from_numpy(real), None, torch.from_numpy(z), None, JaxRng(key),
        augment_fn=taf, ada_p=torch.tensor(0.6), ga_threshold=ga)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    check_metrics(metrics, jm)
    if ga is not None:
        assert float(metrics["Loss/ga/replaced"]) == 1.0
    check_grads(leaves, jgrad)


def test_gd_main_loss_matches_jax():
    """The simultaneous loss: G's gradient through frozen D, D's through
    detached fakes, one backward of the sum."""
    gflat, dflat = tiny_weights(4)
    (jg, jd), (tg, td) = tiny_cfgs(jsg), tiny_cfgs(tsg)
    real, z = tiny_batch(4)
    jaf, taf = augment_fns()
    key = jax.random.PRNGKey(7)

    def jloss(gp, dp):
        return jgl.gd_main_loss(jgl.GANLossConfig(), jg, jd, gp, dp,
                                jnp.asarray(real), None, jnp.asarray(z), None,
                                key, augment_fn=jaf, ada_p=0.6)

    (jl, jm), (jgg, jdg) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
        jck.flat_to_tree(gflat), jck.flat_to_tree(dflat))
    gtree, gleaves = torch_leaves(gflat)
    dtree, dleaves = torch_leaves(dflat)
    for t in list(gleaves.values()) + list(dleaves.values()):
        t.requires_grad_()
    loss, metrics = tgl.gd_main_loss(
        tgl.GANLossConfig(), tg, td, gtree, dtree, torch.from_numpy(real),
        None, torch.from_numpy(z), None, JaxRng(key), augment_fn=taf,
        ada_p=torch.tensor(0.6))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    check_metrics(metrics, jm)
    check_grads(gleaves, jgg)
    check_grads(dleaves, jdg)


def test_d_r1_loss_matches_jax():
    """R1 through the augment pipe: a double backward through D and the
    pipe's gathers."""
    _, dflat = tiny_weights(5)
    _, jd = tiny_cfgs(jsg)
    _, td = tiny_cfgs(tsg)
    real, _ = tiny_batch(5)
    jaf, taf = augment_fns()
    key = jax.random.PRNGKey(8)
    lcfg = dict(r1_gamma=0.5)

    def jloss(dp):
        return jgl.d_r1_loss(jgl.GANLossConfig(**lcfg), jd, dp,
                             jnp.asarray(real), None, key, augment_fn=jaf,
                             ada_p=0.6)

    (jl, jm), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jck.flat_to_tree(dflat))
    dtree, leaves = torch_leaves(dflat)
    for t in leaves.values():
        t.requires_grad_()
    loss, metrics = tgl.d_r1_loss(tgl.GANLossConfig(**lcfg), td, dtree,
                                  torch.from_numpy(real), None, JaxRng(key),
                                  augment_fn=taf, ada_p=torch.tensor(0.6))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    check_metrics(metrics, jm)
    # Second-order sums: summation order counts twice (see
    # test_torch_discriminator's R1 test).
    check_grads(leaves, jgrad, rel=2e-3)


def test_ga_primitives_match_jax():
    rng = np.random.RandomState(9)
    a = rng.randn(3, 5).astype(np.float32)
    b = rng.randn(3, 5).astype(np.float32)
    key = jax.random.PRNGKey(10)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(
        tcm.gaussian_crossover(JaxRng(key), ta, tb).numpy(),
        np.asarray(jcm.gaussian_crossover(key, a, b)), rtol=1e-6, atol=1e-6)
    for got, want in zip(tcm.simulated_binary_crossover(JaxRng(key), ta, tb),
                         jcm.simulated_binary_crossover(key, a, b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        tcm.dynamic_mutation(JaxRng(key), ta, 0.3).numpy(),
        np.asarray(jcm.dynamic_mutation(key, a, 0.3)), rtol=1e-6, atol=1e-6)


def test_genetic_refinement_and_wgan_gp_match_jax():
    gflat, dflat = tiny_weights(6)
    (jg, jd), (tg, td) = tiny_cfgs(jsg), tiny_cfgs(tsg)
    real, z = tiny_batch(6)
    fake, _ = tiny_batch(7)
    ws = np.random.RandomState(8).randn(BATCH, jg.num_ws, 32).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    want, wmask = jrefine.apply_genetic_refinement(
        jg, jck.flat_to_tree(gflat), jd, jck.flat_to_tree(dflat),
        jnp.asarray(real), jnp.asarray(fake), jnp.asarray(ws), key,
        threshold=0.05, return_mask=True)
    got, mask = trefine.apply_genetic_refinement(
        tg, tck.flat_to_tree(gflat), td, tck.flat_to_tree(dflat),
        torch.from_numpy(real), torch.from_numpy(fake), torch.from_numpy(ws),
        JaxRng(key), threshold=0.05, return_mask=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    m = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4 * m)

    jgp = jrefine.wgan_gradient_penalty(jd, jck.flat_to_tree(dflat),
                                        jnp.asarray(real), jnp.asarray(fake),
                                        key)
    tgp = trefine.wgan_gradient_penalty(td, tck.flat_to_tree(dflat),
                                        torch.from_numpy(real),
                                        torch.from_numpy(fake), JaxRng(key))
    np.testing.assert_allclose(float(tgp), float(jgp), rtol=1e-4)
