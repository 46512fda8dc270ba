"""Few-shot offsets training in the train step: every fused-step variant
with an offsets spec and optimizer (Affine+ ``out_in_additive`` and the
low-rank ``out_in_2_2_train_out``) in both phase schedules, against JAX's
``make_fused_step(offsets_spec=..., offsets_tx=...)`` on the same weights
and JAX's draws (``JaxRng``, also for the low-rank family's random
factors), with the offsets optimizer as the JAX loop builds it.

Step tolerances are tests/test_torch_train_step.py's: an Adam step moves a
leaf by about +-lr wherever its gradient is not near zero, so each tree is
held to |port move - JAX move| <= 2 lr per Adam step taken (the offsets
step twice on a Greg batch, in Gmain and in Greg) and moves more than
lr / 4 apart on at most 1% of the elements (a wrong gradient flips about
half of them).  Metrics: 1e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.params import offsets as joffs
from gagan_tpu.train import gan_loss as jgl
from gagan_tpu.train import masks as jmasks
from gagan_tpu.train import train_step as jts
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.params import offsets as toffs
from gagan_tpu_torch.train import gan_loss as tgl
from gagan_tpu_torch.train import train_step as tts
from gagan_tpu_torch.utils import checkpoint as tck

from .test_torch_augment import JaxRng
from .test_torch_gan_loss import tiny_cfgs

torch.set_num_threads(2)


def _jax_offsets_tx(cfg, spec, offsets, parts):
    """The offsets optimizer as the JAX loop builds it
    (gagan_tpu/train/loop.py:122-131)."""
    o_mask = jax.tree.map(lambda a, b: a and b,
                          joffs.trainable_mask(spec, offsets),
                          jmasks.offsets_mask(offsets, parts))
    return optax.multi_transform(
        {"train": optax.adam(cfg.g_lr, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                             eps=cfg.adam_eps),
         "freeze": optax.set_to_zero()},
        jax.tree.map(lambda m: "train" if m else "freeze", o_mask))


def _check_moves(name, before, got, want, lr, steps):
    moved_far = total = 0
    for k, w in want.items():
        d = (got[k] - before[k]) - (w - before[k])
        assert np.abs(d).max() <= 2 * lr * steps + 1e-6, (
            name, k, np.abs(d).max())
        moved_far += int((np.abs(d) > lr / 4).sum())
        total += d.size
    assert moved_far <= 0.01 * total, (name, moved_far, total)


def _flat(tree):
    return {k: np.asarray(v) for k, v in jck.tree_to_flat(tree).items()}


# The step tests run at 16^2 (the parts' inner block is b8 there).
STEP_RES = 16
STEP_PARTS = ("synt_affine", "tRGB_affine", "synt_weights_offset.b8",
              "tRGB_weights_offset.b8")


def _step_weights(seed):
    """tiny_weights at STEP_RES: JAX's init, noise strengths and biases
    non-zero."""
    jg, jd = tiny_cfgs(jsg, STEP_RES)
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
    rng = np.random.RandomState(seed + 2)
    real = rng.uniform(-1, 1, (4, 3, STEP_RES, STEP_RES)).astype(np.float32)
    return g, d, real, rng.randn(4, 32).astype(np.float32)


@pytest.mark.parametrize("variant", ["none", "greg", "both"])
@pytest.mark.parametrize("simultaneous", [True, False])
@pytest.mark.parametrize("family", ["out_in_additive", "out_in_2_2_train_out"])
def test_fused_step_with_offsets_matches_jax(family, simultaneous, variant):
    """Gmain (+Greg) differentiate G's affines and the trainable offsets
    together under the hooks; Dmain runs G under the hooks; the offsets
    take their own Adam step (not lazily scaled) and keep their own EMA."""
    gflat, dflat, real, z = _step_weights(9)
    (jg, jd), (tg, td) = tiny_cfgs(jsg, STEP_RES), tiny_cfgs(tsg, STEP_RES)
    kw = dict(batch_size=4, g_lr=0.02, d_lr=0.002, ema_kimg=0.1,
              ema_rampup=0.05, accum_rounds=2, g_reg_accum_rounds=2,
              d_reg_accum_rounds=2, accum_scan=False,
              simultaneous_main=simultaneous,
              g_requires_grad_parts=STEP_PARTS)
    do_g, do_d = variant in ("greg", "both"), variant == "both"
    key, k_off = jax.random.PRNGKey(13), jax.random.PRNGKey(14)

    jcfg = jts.TrainConfig(**kw, loss=jgl.GANLossConfig(r1_gamma=0.5))
    jspec = joffs.OffsetsSpec.from_string(family, weight_parts=STEP_PARTS)
    joff = joffs.init_offsets(k_off, jg.synthesis, jspec)
    jotx = _jax_offsets_tx(jcfg, jspec, joff, STEP_PARTS)
    jgp, jdp = jck.flat_to_tree(gflat), jck.flat_to_tree(dflat)
    g_tx, d_tx, _, _ = jts.build_optimizers(jcfg, jgp, jdp)
    jstate = jts.init_train_state(jcfg, jgp, jdp, g_tx, d_tx).replace(
        offsets=joff, offsets_ema=jax.tree.map(jnp.copy, joff),
        offsets_opt_state=jotx.init(joff))
    jstep = jts.make_fused_step(jcfg, jg, jd, g_tx, d_tx, do_g_reg=do_g,
                                do_d_reg=do_d, offsets_spec=jspec,
                                offsets_tx=jotx)
    jstate, jm = jstep(jstate, jnp.asarray(real), None, jnp.asarray(z), None,
                       key)

    tcfg = tts.TrainConfig(**kw, loss=tgl.GANLossConfig(r1_gamma=0.5))
    tspec = toffs.OffsetsSpec.from_string(family, weight_parts=STEP_PARTS)
    toff = toffs.init_offsets(JaxRng(k_off), tg.synthesis, tspec)
    off0 = {k: v.copy() for k, v in tck.tree_to_flat(toff).items()}
    for k, v in _flat(joff).items():
        np.testing.assert_allclose(off0[k], v, rtol=1e-6, atol=1e-7)
    otx = tts.build_offsets_optimizer(tcfg, tspec, toff, STEP_PARTS)
    tgp, tdp = tck.flat_to_tree(gflat), tck.flat_to_tree(dflat)
    g_tx, d_tx, _, _ = tts.build_optimizers(tcfg, tgp, tdp)
    state = tts.init_offsets_state(
        tts.init_train_state(tcfg, tgp, tdp, g_tx, d_tx), toff, otx)
    step = tts.make_fused_step(tcfg, tg, td, g_tx, d_tx, do_g_reg=do_g,
                               do_d_reg=do_d, offsets_spec=tspec,
                               offsets_tx=otx)
    frozen = {k: v.clone() for k, v in tck.tree_to_flat_tensors(
        state.g_params).items() if k.endswith("conv1.weight")}
    out, tm = step(state, torch.from_numpy(real), None, torch.from_numpy(z),
                   None, JaxRng(key))
    assert out is state and state.cur_nimg == int(jstate.cur_nimg) == 4

    assert set(tm) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(v), rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    g_steps = 2 if do_g else 1
    _check_moves("G", gflat, tck.tree_to_flat(state.g_params),
                 _flat(jstate.g_params), g_tx.lr, g_steps)
    _check_moves("D", dflat, tck.tree_to_flat(state.d_params),
                 _flat(jstate.d_params), d_tx.lr, 1 + do_d)
    _check_moves("offsets", off0, tck.tree_to_flat(state.offsets),
                 _flat(jstate.offsets), otx.lr, g_steps)
    _check_moves("offsets_ema", off0, tck.tree_to_flat(state.offsets_ema),
                 _flat(jstate.offsets_ema), otx.lr, g_steps)
    assert otx.lr == kw["g_lr"] and g_tx.lr == kw["g_lr"] * 4 / 5
    assert state.offsets_opt_state.count == g_steps
    # The offsets moved where they train and stayed where they are frozen;
    # G's conv weights (not in the parts) did not move.
    trained = dict(otx.mask)
    moved = {k: bool(np.any(v != off0[k]))
             for k, v in tck.tree_to_flat(state.offsets).items()}
    assert moved == {k: trained[k] for k in moved}, moved
    for k, v in frozen.items():
        assert torch.equal(tck.tree_to_flat_tensors(state.g_params)[k], v), k
    assert not any(t.requires_grad for t in tck.tree_to_flat_tensors(
        state.offsets).values())
