"""Data parallelism of the port's train step (parallel/mesh.py) against the
one-process step and JAX's ``shard_train_step``.

Two gloo ranks on the CPU run the fused step (simultaneous Gmain+Dmain
through the ADA pipe, two accumulation rounds, Greg with
``pl_batch_shrink=2``, Dreg and the GA splice) in all three scheduled
variants from the same state as:

(a) the port's one-process step on the global batch, and
(b) JAX's ``make_fused_step`` jitted by ``shard_train_step`` over
    ``create_mesh(2)`` from the same weights and key.

G and D are ``dryrun_multichip``'s but at 8^2: each variant is a cold XLA
compile, 15-35 s at 8^2 against 45-60 s at 32^2, and the suite has a time
limit.  The one-process run draws from JAX's key tree (``JaxRng``) and
records its draws; the ranks replay them (``tests/torch_draws.py``), so all
three runs see JAX's numbers.  The batch is 8 in rounds of 4, and D's mbstd
group is 4, so every minibatch-stddev group holds two samples of each rank.

Tolerance: rtol 1e-4 / atol 1e-5, JAX's own for its sharded step
(``tests/test_train_step.py::test_data_parallel_step_matches_single_device``)
on the metrics, every updated leaf of the state (parameters, G_ema, both
Adam moments, whose first is the phase's averaged gradient since beta1 is
0), ``pl_mean``, ``w_avg``, and ``ada_p`` after ``ada_update`` from each
run's ``Loss/signs/real``.  Adam's eps is 1e-3 here: with the default 1e-8
the first step moves each element by lr * sign(g), which fp32 rounding
decides wherever g is near 0 (the two runs sum the batch in another
order), and the next phase then starts from another state; with 1e-3 a step
is a smooth function of the gradient, so the parameters carry the
gradients' agreement.

The step's gradient is not continuous everywhere (leaky ReLU at 0, the
warp's texel edges): where an activation of these inputs lies within fp32
rounding of a kink, a bias gradient element jumps by ~3e-5 between two
runs that sum in other orders.  The same one-process step gave two values
of one D bias gradient element with 2 and with 4 CPU threads at 32^2,
while JAX on one device and JAX sharded agreed bit for bit.  So the
fixture first checks that its inputs are not such a point: nudging the
real images and z by 2e-6 relative moves no leaf by more than a quarter of
the tolerance.  The ranks' states are bit-equal to each other.
``minibatch_std`` across ranks is held to JAX's forward, backward and R1's
double backward on the global batch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.parallel import (create_mesh, place_state, shard_batch,
                                shard_train_step)
from gagan_tpu.train import augment as jaug
from gagan_tpu.train import gan_loss as jgl
from gagan_tpu.train import train_step as jts
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.parallel import dryrun
from gagan_tpu_torch.parallel import mesh as tmesh
from gagan_tpu_torch.train import augment as taug
from gagan_tpu_torch.train import gan_loss as tgl
from gagan_tpu_torch.train import train_step as tts

from .test_torch_augment import JaxRng
from .torch_draws import RecordingRng

torch.set_num_threads(2)

VARIANTS = ("none", "greg", "both")
RTOL, ATOL = 1e-4, 1e-5
TIMEOUT = 120
RES, ADA_P, NUDGE = 8, 0.6, 2e-6


def _jax_cfgs():
    g = jsg.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=RES, img_channels=3,
        mapping=jsg.MappingConfig(num_layers=2),
        synthesis=jsg.SynthesisConfig(channel_base=1024, channel_max=64))
    d = jsg.DiscriminatorConfig(img_resolution=RES, img_channels=3,
                                channel_base=1024, channel_max=64,
                                mbstd_group_size=4)
    return g, d


def _weights():
    jg, jd = _jax_cfgs()
    g = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0), jg))
    d = jck.tree_to_flat(jsg.init_discriminator(jax.random.PRNGKey(1), jd))
    rng = np.random.RandomState(0)
    for flat in (g, d):
        for k, v in flat.items():
            if k.endswith("noise_strength"):
                flat[k] = np.float32(rng.uniform(0.1, 0.3))
            elif k.endswith(".bias") and ".affine." not in k:
                flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return g, d


CFG = dict(batch_size=8, simultaneous_main=True, accum_rounds=2,
           ga_threshold=0.5, ema_kimg=0.1, adam_eps=1e-3, ada_target=0.6)
LOSS = dict(r1_gamma=0.5, pl_batch_shrink=2)


def _within(got, want, frac=1.0):
    """The leaves (and where) that differ by more than ``frac`` of the
    tolerance."""
    bad = []
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            g64, w64 = got[k].double(), v.double()
            excess = (g64 - w64).abs() - frac * (ATOL + RTOL * w64.abs())
            if bool((excess > 0).any()):
                bad.append((k, float(excess.max())))
    return bad


@pytest.fixture(scope="module")
def runs():
    gflat, dflat = _weights()
    rng = np.random.RandomState(7)
    real = rng.uniform(-1, 1, (8, 3, RES, RES)).astype(np.float32)
    z = rng.randn(8, 32).astype(np.float32)
    key = jax.random.PRNGKey(12)

    tg, td = dryrun.tiny_configs(mbstd_group_size=4, img_resolution=RES)
    tcfg = tts.TrainConfig(**CFG, loss=tgl.GANLossConfig(**LOSS))
    rec = RecordingRng(JaxRng(key))
    case = dryrun.StepCase(tg, td, tcfg, real, z, rec, weights=(gflat, dflat),
                           augment_cfg=taug.make_config("bgc"), ada_p=ADA_P)
    one = dryrun.run_variants(None, *case.build(None, "cpu"), VARIANTS)
    nudged = dataclasses.replace(case, real=real * np.float32(1 + NUDGE),
                                 z=z * np.float32(1 + NUDGE),
                                 key=rec.replay())
    kinks = {v: _within(r["state"], one[v]["state"], 0.25) for v, r in
             dryrun.run_variants(None, *nudged.build(None, "cpu"),
                                 VARIANTS).items()}
    ranks = tmesh.spawn(dryrun.step_rank, 2, devices="cpu", timeout=TIMEOUT,
                        limit=TIMEOUT,
                        args=(dataclasses.replace(case, key=rec.replay()),
                              VARIANTS))

    jg, jd = _jax_cfgs()
    jcfg = jts.TrainConfig(**CFG, loss=jgl.GANLossConfig(**LOSS))
    augment_fn = jaug.make_augment_fn(jaug.make_config("bgc"))
    mesh = create_mesh(2)
    jreal, jz = shard_batch(mesh, (jnp.asarray(real), jnp.asarray(z)))
    jx = {}
    for name, do_g, do_d in dryrun.VARIANTS:
        jgp, jdp = jck.flat_to_tree(gflat), jck.flat_to_tree(dflat)
        g_tx, d_tx, _, _ = jts.build_optimizers(jcfg, jgp, jdp)
        state = jts.init_train_state(jcfg, jgp, jdp, g_tx, d_tx).replace(
            ada_p=jnp.float32(ADA_P))
        state = place_state(mesh, state)
        step = shard_train_step(jts.make_fused_step(
            jcfg, jg, jd, g_tx, d_tx, augment_fn=augment_fn, do_g_reg=do_g,
            do_d_reg=do_d), mesh, donate_state=False)
        state, metrics = step(state, jreal, None, jz, None, key)
        jx[name] = (jax.device_get(state), {k: np.asarray(v)
                                            for k, v in metrics.items()})
    return {"one": one, "kinks": kinks, "ranks": ranks, "jax": jx,
            "tcfg": tcfg, "jcfg": jcfg}


def _jax_leaves(state):
    """JAX's state under the port's leaf paths."""
    out = {"pl_mean": np.asarray(state.pl_mean),
           "ada_p": np.asarray(state.ada_p)}
    for tree in ("g_params", "d_params", "g_ema"):
        for k, v in jck.tree_to_flat(getattr(state, tree)).items():
            out[f"{tree}/" + k.replace(".", "/")] = np.asarray(v)
    return out


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _close_state(got, want):
    for k, v in want.items():
        if isinstance(v, torch.Tensor) or isinstance(v, np.ndarray):
            _close(got[k], v, k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("variant", VARIANTS)
def test_ranks_are_bit_equal(runs, variant):
    a, b = (r[variant]["state"] for r in runs["ranks"])
    assert set(a) == set(b)
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


@pytest.mark.parametrize("variant", VARIANTS)
def test_ranks_match_one_process_step(runs, variant):
    assert runs["kinks"][variant] == [], (
        "the inputs lie at a kink of the step's gradient")
    got, want = runs["ranks"][0][variant], runs["one"][variant]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        _close(got["metrics"][k], v, k)
    assert set(got["state"]) == set(want["state"])
    _close_state(got["state"], want["state"])
    moved = [k for k, v in want["state"].items()
             if k.startswith("g_opt_state/mu") and bool(v.abs().max())]
    assert len(moved) > 10
    if variant != "none":
        assert float(want["state"]["pl_mean"]) > 0
    p = [tts.ada_update(runs["tcfg"], ADA_P, float(r["metrics"][
        "Loss/signs/real"])) for r in (got, want)]
    assert p[0] == p[1] != ADA_P


@pytest.mark.parametrize("variant", VARIANTS)
def test_ranks_match_jax_shard_train_step(runs, variant):
    assert runs["kinks"][variant] == [], (
        "the inputs lie at a kink of the step's gradient")
    got = runs["ranks"][0][variant]
    jstate, jmetrics = runs["jax"][variant]
    assert set(got["metrics"]) == set(jmetrics)
    for k, v in jmetrics.items():
        _close(got["metrics"][k], v, k)
    want = _jax_leaves(jstate)
    assert "g_params/mapping/w_avg" in want and "pl_mean" in want
    _close_state(got["state"], want)
    assert got["state"]["cur_nimg"] == int(jstate.cur_nimg) == 8
    p = [float(tts.ada_update(runs["tcfg"], ADA_P, float(got["metrics"][
        "Loss/signs/real"]))),
         float(jts.ada_update(runs["jcfg"], jnp.float32(ADA_P),
                              jmetrics["Loss/signs/real"]))]
    _close(p[0], p[1], "ada_p after ada_update")


@pytest.mark.parametrize("geom", ["exact", "fast"])
def test_augment_pipe_across_ranks_is_bit_equal(geom):
    """The ADA pipe (bgc, p = 0.6) on two ranks' shares, with the global
    batch's draws: each rank's images and input gradients are the
    one-process pipe's, bit for bit.  The exact geometry pads by a margin
    taken over the batch, which over two ranks is the global batch's."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)
    w = rng.randn(4, 3, 32, 32).astype(np.float32)
    cfg = dataclasses.replace(taug.make_config("bgc"), geom_mode=geom)
    rec = RecordingRng(JaxRng(jax.random.PRNGKey(3)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = taug.augment_pipe(cfg, xt, 0.6, rec)
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xt)
    ranks = tmesh.spawn(dryrun.augment_rank, 2, devices="cpu",
                        timeout=TIMEOUT, limit=TIMEOUT,
                        args=(cfg, x, w, 0.6, rec.replay()))
    np.testing.assert_array_equal(
        np.concatenate([r["images"] for r in ranks]), y.detach().numpy())
    np.testing.assert_array_equal(
        np.concatenate([r["grad"] for r in ranks]), g.numpy())


def test_minibatch_std_across_ranks_matches_jax():
    """Forward, backward and R1's double backward of the layer over two
    ranks (2 samples each, groups of 4) against JAX's on the batch of 4."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 8, 4, 4).astype(np.float32)
    w = rng.randn(4, 9, 4, 4).astype(np.float32)

    def f(xx):
        return jnp.sum(jsg.minibatch_std(xx, 4, 1) * w)

    grad = jax.grad(f)
    want = {"out": np.asarray(jsg.minibatch_std(jnp.asarray(x), 4, 1)),
            "grad": np.asarray(grad(jnp.asarray(x))),
            "grad2": np.asarray(jax.grad(
                lambda xx: jnp.sum(jnp.square(grad(xx))))(jnp.asarray(x)))}
    ranks = tmesh.spawn(dryrun.mbstd_rank, 2, devices="cpu", timeout=TIMEOUT,
                        limit=TIMEOUT, args=(x, w, 4))
    for k, v in want.items():
        got = np.concatenate([r[k] for r in ranks])
        np.testing.assert_allclose(got, v, rtol=1e-5,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)
