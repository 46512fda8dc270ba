"""The port's train step (gagan_tpu_torch.train.train_step, masks) against
the JAX package's, on the same weights and draws (JAX's key tree through
``JaxRng``): masks with Freeze-D, the masked lazy-scaled Adam against
optax, rounds averaging, EMA, ADA, and one ``make_fused_step`` per
scheduled variant at a tiny config, simultaneous and alternating, with the
GA splice and the ADA pipe on.

Step tolerances.  The first Adam step moves each parameter by lr * g /
(|g| + eps): about +-lr whatever |g| is, so where a gradient is near zero
the two packages' gradients (equal to 1e-3 of max|g|) can round to opposite
signs and the moves differ by up to 2 lr.  Each tree is held to: every
move within 2 lr + 1e-6 of JAX's, and moves more than lr / 4 apart on at
most 1% of the elements (a wrong gradient flips about half of them).
Metrics: 1e-3 relative (the phases after the first see those moves).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.train import gan_loss as jgl
from gagan_tpu.train import masks as jmasks
from gagan_tpu.train import train_step as jts
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.ops import fused_modconv as fmc
from gagan_tpu_torch.train import gan_loss as tgl
from gagan_tpu_torch.train import masks as tmasks
from gagan_tpu_torch.train import train_step as tts
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils.rng import Rng

from .test_torch_augment import JaxRng
from .test_torch_gan_loss import (augment_fns, tiny_batch, tiny_cfgs,
                                  tiny_weights)

torch.set_num_threads(2)


# ----------------------------------------------------------------------------
# Masks


@pytest.mark.parametrize("parts", [("all",), ("mapping",),
                                   ("synt_conv.b16", "tRGB_affine"),
                                   ("synt_affine", "synt_const")])
def test_generator_mask_matches_jax(parts):
    gflat, _ = tiny_weights()
    want = jck.tree_to_flat(jmasks.generator_mask(jck.flat_to_tree(gflat),
                                                  parts))
    got = tck.tree_to_flat_tensors(tmasks.generator_mask(
        tck.flat_to_tree(gflat), parts))
    assert {k: bool(v) for k, v in want.items()} == got


@pytest.mark.parametrize("freeze", [0, 1, 3, 100])
def test_discriminator_mask_matches_jax(freeze):
    _, dflat = tiny_weights()
    want = jck.tree_to_flat(jmasks.discriminator_mask(
        jck.flat_to_tree(dflat), ("all",), freeze))
    got = tck.tree_to_flat_tensors(tmasks.discriminator_mask(
        tck.flat_to_tree(dflat), ("all",), freeze))
    assert {k: bool(v) for k, v in want.items()} == got
    if freeze == 1:
        assert not got["b32.fromrgb.weight"] and got["b32.conv0.weight"]
    assert tmasks.is_buffer(("mapping", "w_avg"))
    with pytest.raises(ValueError, match="Unknown"):
        tmasks.path_trainable("synthesis.b8.conv0.weight", ("bogus",))


# ----------------------------------------------------------------------------
# Optimizer, rounds, EMA, ADA


def test_masked_adam_matches_optax_over_three_steps():
    rng = np.random.RandomState(0)
    params = {"a": {"w": rng.randn(4, 3).astype(np.float32)},
              "b": rng.randn(5).astype(np.float32),
              "w_avg": rng.randn(2).astype(np.float32)}
    mask = {"a": {"w": True}, "b": True, "w_avg": False}
    grads = [{"a": {"w": rng.randn(4, 3).astype(np.float32)},
              "b": rng.randn(5).astype(np.float32) * 1e-3,
              "w_avg": rng.randn(2).astype(np.float32)} for _ in range(3)]
    jtx = jts._masked(jts._lazy_scaled_adam(0.01, (0.5, 0.99), 1e-8, 4), mask)
    ttx = tts._masked(tts._lazy_scaled_adam(0.01, (0.5, 0.99), 1e-8, 4),
                      mask)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tp = tck.flat_to_tree({"a.w": params["a"]["w"], "b": params["b"],
                           "w_avg": params["w_avg"]})
    tstate = ttx.init(tp)
    assert set(tstate.mu) == {"a.w", "b"}
    for g in grads:
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.update_({k: torch.from_numpy(v) for k, v in
                     tck.tree_to_flat(g).items()}, tstate, tp)
    for k, v in jck.tree_to_flat(jp).items():
        np.testing.assert_allclose(tck.tree_to_flat(tp)[k], np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert tstate.count == 3
    np.testing.assert_array_equal(tck.tree_to_flat(tp)["w_avg"],
                                  params["w_avg"])


def test_accum_averages_rounds():
    """Rounds average both the metrics and the gradients: equal to one
    round over the whole batch for per-sample means."""
    x = torch.arange(8.0).reshape(8, 1)
    w = torch.tensor([2.0])

    def run_round_for(rounds):
        def run_round(r, k):
            xi = tts._chunk(x, rounds, r)
            loss = (xi * w).square().mean()
            return loss, {"loss": loss.detach()}
        return run_round

    m1, g1 = tts._accum(run_round_for(1), 1, None, {"w": w})
    m4, g4 = tts._accum(run_round_for(4), 4, JaxRng(jax.random.PRNGKey(0)),
                        {"w": w})
    assert torch.allclose(m1["loss"], m4["loss"])
    assert torch.allclose(g1["w"], g4["w"])
    assert not w.requires_grad and w.grad is None
    with pytest.raises(ValueError, match="divide"):
        tts._chunk(x, 3, 0)


@pytest.mark.parametrize("rampup", [None, 0.05])
def test_ema_update_matches_jax(rampup):
    gflat, _ = tiny_weights()
    rng = np.random.RandomState(1)
    eflat = {k: (v + rng.randn(*np.shape(v)).astype(np.float32)
                 if np.ndim(v) else v + np.float32(0.1))
             for k, v in gflat.items()}
    cfg_kw = dict(ema_kimg=0.5, ema_rampup=rampup, batch_size=8)
    want = jts.ema_update(jck.flat_to_tree(gflat), jck.flat_to_tree(eflat),
                          jnp.int32(64), jts.TrainConfig(**cfg_kw))
    g_ema = tck.flat_to_tree(eflat)
    tts.ema_update(tck.flat_to_tree(gflat), g_ema, 64,
                   tts.TrainConfig(**cfg_kw))
    got = tck.tree_to_flat(g_ema)
    for k, v in jck.tree_to_flat(want).items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert np.array_equal(got["mapping.w_avg"], gflat["mapping.w_avg"])


@pytest.mark.parametrize("signs,p", [(0.9, 0.3), (0.1, 0.3), (0.9, 0.999),
                                     (-1.0, 0.0)])
def test_ada_update_matches_jax(signs, p):
    kw = dict(ada_target=0.6, batch_size=32)
    assert tts.ada_update(tts.TrainConfig(**kw), p, signs) == pytest.approx(
        float(jts.ada_update(jts.TrainConfig(**kw), p, signs)), abs=1e-12)


def test_train_config_fields_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jts.TrainConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tts.TrainConfig)]
    assert tf == jf
    assert (dataclasses.asdict(jgl.GANLossConfig())
            == dataclasses.asdict(tgl.GANLossConfig()))


def test_unported_options_raise():
    """``extra_hooks`` and ``d_constraint``, refused while spatial sharding
    was not ported, now run: an empty hook tree and an identity constraint
    leave the step bit-equal to the plain one
    (tests/test_torch_spatial.py holds the spatial ones over two ranks); a
    spatially sharded step refuses a data-parallel mesh."""
    from gagan_tpu_torch.parallel import mesh as tmesh
    from gagan_tpu_torch.parallel import spatial as tsp

    gflat, dflat = tiny_weights()
    g, d = tiny_cfgs(tsg)
    cfg = tts.TrainConfig(batch_size=2, g_reg_interval=None,
                          d_reg_interval=None)
    real, z = (torch.from_numpy(a) for a in tiny_batch(n=2))
    states = []
    for kw in ({}, {"extra_hooks": {}}, {"d_constraint": lambda t: t}):
        gp, dp = tck.flat_to_tree(gflat), tck.flat_to_tree(dflat)
        g_tx, d_tx, _, _ = tts.build_optimizers(cfg, gp, dp)
        state = tts.init_train_state(cfg, gp, dp, g_tx, d_tx)
        step = tts.make_fused_step(cfg, g, d, g_tx, d_tx, **kw)
        states.append(tck.tree_to_flat_tensors(
            step(state, real, None, z, None, Rng(3))[0].g_params))
    for other in states[1:]:
        assert all(torch.equal(other[k], v) for k, v in states[0].items())
    mesh = tmesh.Mesh(2, 0, torch.device("cpu"), "gloo", object())
    step = tts.make_fused_step(cfg, g, d, g_tx, d_tx, d_constraint=(
        tsp.d_spatial_constraint(mesh)))
    with pytest.raises(ValueError, match="without a mesh"):
        step(state, real, None, z, None, Rng(3), mesh=mesh)


# ----------------------------------------------------------------------------
# The fused step against JAX's


def _check_moves(name, before, got, want, lr):
    moved_far = total = 0
    for k, w in want.items():
        d = (got[k] - before[k]) - (w - before[k])
        assert np.abs(d).max() <= 2 * lr + 1e-6, (name, k, np.abs(d).max())
        moved_far += int((np.abs(d) > lr / 4).sum())
        total += d.size
    assert moved_far <= 0.01 * total, (name, moved_far, total)


@pytest.mark.parametrize("variant", ["none", "greg", "both"])
@pytest.mark.parametrize("simultaneous", [True, False])
def test_fused_step_matches_jax(simultaneous, variant):
    gflat, dflat = tiny_weights(7)
    (jg, jd), (tg, td) = tiny_cfgs(jsg), tiny_cfgs(tsg)
    real, z = tiny_batch(7, n=8)
    jaf, taf = augment_fns()
    kw = dict(batch_size=8, g_lr=0.002, d_lr=0.002, ema_kimg=0.1,
              accum_rounds=2, g_reg_accum_rounds=2, d_reg_accum_rounds=2,
              accum_scan=False, simultaneous_main=simultaneous,
              ga_threshold=0.5)
    do_g, do_d = variant in ("greg", "both"), variant == "both"
    key = jax.random.PRNGKey(12)

    jcfg = jts.TrainConfig(**kw, loss=jgl.GANLossConfig(r1_gamma=0.5))
    jgp, jdp = jck.flat_to_tree(gflat), jck.flat_to_tree(dflat)
    g_tx, d_tx, _, _ = jts.build_optimizers(jcfg, jgp, jdp)
    jstate = jts.init_train_state(jcfg, jgp, jdp, g_tx, d_tx)
    jstate = jstate.replace(ada_p=jnp.float32(0.6))
    jstep = jts.make_fused_step(jcfg, jg, jd, g_tx, d_tx, augment_fn=jaf,
                                do_g_reg=do_g, do_d_reg=do_d)
    jstate, jm = jstep(jstate, jnp.asarray(real), None, jnp.asarray(z), None,
                       key)

    tcfg = tts.TrainConfig(**kw, loss=tgl.GANLossConfig(r1_gamma=0.5))
    tgp, tdp = tck.flat_to_tree(gflat), tck.flat_to_tree(dflat)
    g_tx, d_tx, _, _ = tts.build_optimizers(tcfg, tgp, tdp)
    state = tts.init_train_state(tcfg, tgp, tdp, g_tx, d_tx)
    state.ada_p = torch.tensor(0.6)
    step = tts.make_fused_step(tcfg, tg, td, g_tx, d_tx, augment_fn=taf,
                               do_g_reg=do_g, do_d_reg=do_d)
    out, tm = step(state, torch.from_numpy(real), None, torch.from_numpy(z),
                   None, JaxRng(key))
    assert out is state and state.cur_nimg == int(jstate.cur_nimg) == 8

    assert set(tm) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(v), rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    assert "Loss/ga/replaced" in tm
    lr_g, lr_d = g_tx.lr, d_tx.lr
    _check_moves("G", gflat, tck.tree_to_flat(state.g_params),
                 {k: np.asarray(v) for k, v in
                  jck.tree_to_flat(jstate.g_params).items()}, lr_g)
    _check_moves("D", dflat, tck.tree_to_flat(state.d_params),
                 {k: np.asarray(v) for k, v in
                  jck.tree_to_flat(jstate.d_params).items()}, lr_d)
    beta = 1 - 0.5 ** (8 / 100.0)
    _check_moves("G_ema", gflat, tck.tree_to_flat(state.g_ema),
                 {k: np.asarray(v) for k, v in
                  jck.tree_to_flat(jstate.g_ema).items()}, beta * lr_g)
    np.testing.assert_allclose(float(state.pl_mean), float(jstate.pl_mean),
                               rtol=1e-3, atol=1e-7)
    if do_g:
        assert float(state.pl_mean) > 0


def test_pl_phase_refuses_the_fused_level(monkeypatch):
    """With pallas_level on in the Greg config, the fused level's
    first-order backward refuses the path-length double backward."""
    g = tsg.GeneratorConfig(
        z_dim=16, w_dim=16, img_resolution=8,
        mapping=tsg.MappingConfig(num_layers=1),
        synthesis=tsg.SynthesisConfig(channel_base=1024, channel_max=128,
                                      pallas_level=True))
    params = tsg.init_generator(g, torch.Generator().manual_seed(0), "cpu")
    leaves = tck.tree_to_flat_tensors(params)
    for t in leaves.values():
        t.requires_grad_()
    z = torch.randn((2, 16), generator=torch.Generator().manual_seed(1))
    called = []
    monkeypatch.setattr(fmc, "supported_shape",
                        lambda *a, **k: called.append(1) or True)
    loss, _ = tgl.g_pl_loss(tgl.GANLossConfig(style_mixing_prob=0), g, params,
                            z, None, Rng(0), torch.tensor(0.0))
    assert called
    with pytest.raises(RuntimeError, match="differentiate twice"):
        loss.backward()
