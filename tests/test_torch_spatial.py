"""Spatial (height) sharding of the port (gagan_tpu_torch/parallel/spatial.py)
against JAX's (gagan_tpu/parallel/spatial.py) and the port's one-process
runs.

One module-scoped spawn of two gloo ranks on the CPU runs every check that
needs ranks (``dryrun.spatial_rank``); the results are held case by case:

* the hook keys of ``spatial_sharding_hooks`` against JAX's for several
  (resolution, ranks, min_res), the min_rows floor among them
  (``tests/test_train_step.py::test_spatial_sharded_full_train_step``);
* ``spatial_synthesis_fn``'s gathered image at 32^2 against JAX's on
  ``create_mesh(2)`` and the port's one-process forward, with and without
  offsets base hooks, and with the 4x4 block sharded;
* each exchange pair (halo, enter, gather): <A x, y> = <x, A^T y> in
  float64 over the ranks, and gradcheck / gradgradcheck of a map through it;
* D under ``d_spatial_constraint`` (packed first block) against D without
  it: logits, R1 and R1's gradient of every D leaf;
* the fused step's three variants (simultaneous Gmain+Dmain through the ADA
  pipe, Greg, Dreg, the GA splice, a packed first block) at
  16^2 with ``min_res=8`` against the one-process step on every leaf, the
  ranks bit-equal; the inputs are checked to lie off gradient kinks, as in
  ``test_torch_dp_step.py``.

Tolerance: rtol 1e-4 / atol 1e-5, JAX's own for its sharded runs
(``tests/test_train_step.py:251-256,319-320``).  A ``slow`` test holds the
spatial step against JAX's own spatially sharded step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.parallel import create_mesh, place_state
from gagan_tpu.parallel import spatial as jsp
from gagan_tpu.params import offsets as joffs
from gagan_tpu.train import augment as jaug
from gagan_tpu.train import gan_loss as jgl
from gagan_tpu.train import train_step as jts
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.parallel import dryrun
from gagan_tpu_torch.parallel import mesh as tmesh
from gagan_tpu_torch.parallel import spatial as tsp
from gagan_tpu_torch.params import offsets as toffs
from gagan_tpu_torch.train import augment as taug
from gagan_tpu_torch.train import gan_loss as tgl
from gagan_tpu_torch.train import train_step as tts
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils import config as tconfig
from gagan_tpu_torch.utils.rng import Rng

from .test_torch_augment import JaxRng
from .torch_draws import RecordingRng

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
TIMEOUT = 120
VARIANTS = ("none", "greg", "both")
NUDGE = 2e-6
SYNTH_RES, STEP_RES = 32, 16
# (label, min_res, with offsets, held against JAX's spatial_synthesis_fn)
SYNTH_RUNS = (("plain", 16, False, True), ("offsets", 16, True, True),
              ("4x4", 4, False, False))


def _configs(res, packed_first_block=False):
    g = jsg.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=res, img_channels=3,
        mapping=jsg.MappingConfig(num_layers=2),
        synthesis=jsg.SynthesisConfig(channel_base=1024, channel_max=64))
    d = jsg.DiscriminatorConfig(img_resolution=res, img_channels=3,
                                channel_base=1024, channel_max=64,
                                mbstd_group_size=4,
                                packed_first_block=packed_first_block)
    return g, d


def _port(cfg):
    """The port's config of a JAX G or D config (through its dict)."""
    data = jconfig.to_dict(cfg)
    if isinstance(cfg, jsg.GeneratorConfig):
        return tconfig.generator_config_from_dict(data)
    return tconfig.discriminator_config_from_dict(data)


def _weights(g_cfg, d_cfg):
    """JAX-initialised weights, noise strengths and conv biases made
    non-zero (zero at init), as flat numpy."""
    g = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0), g_cfg))
    d = jck.tree_to_flat(jsg.init_discriminator(jax.random.PRNGKey(1), d_cfg))
    rng = np.random.RandomState(0)
    for flat in (g, d):
        for k, v in flat.items():
            if k.endswith("noise_strength"):
                flat[k] = np.float32(rng.uniform(0.1, 0.3))
            elif k.endswith(".bias") and ".affine." not in k:
                flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return g, d


def _offsets(g_cfg):
    """JAX's "additive" offsets (+0.05, so that they act), as (spec, the
    JAX tree, the tree as numpy)."""
    spec = joffs.OffsetsSpec.from_string("additive")
    tree = jax.tree.map(lambda x: x + 0.05, joffs.init_offsets(
        jax.random.PRNGKey(1), g_cfg.synthesis, spec))
    return spec, tree, {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                        for k, v in tree.items()}


STEP_CFG = dict(batch_size=4, simultaneous_main=True, accum_rounds=1,
                ga_threshold=0.5, ema_kimg=0.1, adam_eps=1e-3, ada_target=0.6)
STEP_LOSS = dict(r1_gamma=0.5, pl_batch_shrink=2)


def _step_case(key, real, z, weights, real_scale=1.0):
    jg, jd = _configs(STEP_RES, packed_first_block=True)
    cfg = tts.TrainConfig(**STEP_CFG, loss=tgl.GANLossConfig(**STEP_LOSS))
    return dryrun.StepCase(
        _port(jg), _port(jd), cfg, (real * np.float32(real_scale)),
        (z * np.float32(real_scale)), key, weights=weights,
        augment_cfg=taug.make_config("bgc"), ada_p=0.6, spatial_min_res=8)


def _within(got, want, frac=1.0):
    """The leaves that differ by more than ``frac`` of the tolerance."""
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
    # Synthesis and D at 32^2.
    jg, jd = _configs(SYNTH_RES, packed_first_block=True)
    gflat, dflat = _weights(jg, jd)
    ws = np.asarray(jsg.mapping_apply(
        jg.mapping, jck.flat_to_tree(gflat)["mapping"],
        jax.random.normal(jax.random.PRNGKey(2), (2, 32))))
    spec, jtree, tree = _offsets(jg)
    synth = (_port(jg), gflat, ws,
             [(label, min_res, ("additive", tree) if offs else None)
              for label, min_res, offs, _ in SYNTH_RUNS])
    real32 = np.random.RandomState(5).uniform(
        -1, 1, (4, 3, SYNTH_RES, SYNTH_RES)).astype(np.float32)

    # The step at 16^2.
    sg, sd = _configs(STEP_RES, packed_first_block=True)
    sgflat, sdflat = _weights(sg, sd)
    rng = np.random.RandomState(7)
    real = rng.uniform(-1, 1, (4, 3, STEP_RES, STEP_RES)).astype(np.float32)
    z = rng.randn(4, 32).astype(np.float32)
    case = _step_case(Rng(12), real, z, (sgflat, sdflat))
    one = dryrun.run_variants(None, *case.build(None, "cpu"), VARIANTS)
    nudged = _step_case(Rng(12), real, z, (sgflat, sdflat), 1 + NUDGE)
    kinks = {v: _within(r["state"], one[v]["state"], 0.25) for v, r in
             dryrun.run_variants(None, *nudged.build(None, "cpu"),
                                 VARIANTS).items()}

    ranks = tmesh.spawn(
        dryrun.spatial_rank, 2, devices="cpu", timeout=TIMEOUT,
        limit=TIMEOUT,
        args=(dryrun.SpatialCase(synthesis=synth,
                                 d=(_port(jd), dflat, real32), step=case,
                                 probes=True),))

    # The port's one-process synthesis and D.
    tg = _port(jg)
    gparams = tck.flat_to_tree(gflat)
    thooks = toffs.make_hooks(toffs.OffsetsSpec.from_string("additive"), {
        k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
        for k, v in tree.items()})
    one_synth = {}
    for label, _, offs, _ in SYNTH_RUNS:
        one_synth[label] = tsg.synthesis_apply(
            tg.synthesis, gparams["synthesis"], torch.from_numpy(ws),
            hooks=thooks if offs else None).numpy()
    one_d = dryrun.spatial_d(tmesh.Mesh(1, 0, torch.device("cpu")),
                             _port(jd), dflat, real32)

    # JAX's spatial_synthesis_fn on create_mesh(2).
    mesh = create_mesh(2)
    placed = place_state(mesh, jck.flat_to_tree(gflat))
    jbase = joffs.make_hooks(spec, jtree)
    jx = {}
    for label, min_res, offs, with_jax in SYNTH_RUNS:
        if with_jax:
            fn = jsp.spatial_synthesis_fn(jg, mesh, min_res=min_res,
                                          base_hooks=jbase if offs else None)
            jx[label] = np.asarray(fn(placed, jnp.asarray(ws)))
    return {"ranks": ranks, "one": one, "kinks": kinks,
            "one_synth": one_synth, "one_d": one_d, "jax": jx}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


# ----------------------------------------------------------------------------
# Without ranks


def _fake_mesh(n):
    """A rank-0 mesh of ``n`` ranks for the calls that run no collective."""
    return tmesh.Mesh(n, 0, torch.device("cpu"), "gloo",
                      None if n == 1 else object())


@pytest.mark.parametrize("res,n,min_res", [
    (32, 8, 8), (32, 2, 8), (32, 2, 4), (64, 4, 16), (1024, 2, 256),
    (1024, 8, 64), (16, 1, 4)])
def test_hook_keys_match_jax(res, n, min_res):
    """The keys (b{res}.conv0 / conv1 at res >= min_res and >= min_rows *
    n; only conv1 at 4x4) equal JAX's; each holds a "post" slot, a numeric
    identity that carries the row layout.  (32, 8, 8) is the floor case of
    JAX's full-step test: b8 stays replicated, b16 is sharded."""
    jg, _ = _configs(res)
    want = jsp.spatial_sharding_hooks(jg.synthesis, create_mesh(n),
                                      min_res=min_res)
    got = tsp.spatial_sharding_hooks(_port(jg).synthesis, _fake_mesh(n),
                                     min_res=min_res)
    assert set(got) == set(want)
    assert all(set(v) == {"post"} for v in got.values())
    for slots in got.values():
        x = torch.randn(2, 3)
        assert slots["post"](x) is x
        assert slots["post"].row_layout.world_size == n
    if (res, n, min_res) == (32, 8, 8):
        assert "b8.conv1" not in got and "b16.conv1" in got
    if min_res == 4 and n * 2 <= 4:
        assert "b4.conv1" in got and "b4.conv0" not in got


def test_layout_survives_merge_hooks_in_either_order():
    """merge_hooks composes two "post" slots; the layout that one carries
    survives in either order, and the composition still runs both."""
    hooks = tsp.spatial_sharding_hooks(_port(_configs(32)[0]).synthesis,
                                       _fake_mesh(2), min_res=16)
    other = {"b32.conv1": {"post": lambda v: v * 2.0}}
    x = torch.ones(3)
    for merged in (tsp.merge_hooks(hooks, other),
                   tsp.merge_hooks(other, hooks)):
        post = merged["b32.conv1"]["post"]
        assert post.row_layout is hooks["b32.conv1"]["post"].row_layout
        assert torch.equal(post(x), x * 2.0)
        assert tsp.hooks_layout(merged) is post.row_layout
    assert tsp.is_spatial(hooks, None)
    assert not tsp.is_spatial(tsp.spatial_sharding_hooks(
        _port(_configs(32)[0]).synthesis, _fake_mesh(1), min_res=16), None)


@pytest.mark.parametrize("n,h,stride2,match", [
    (2, 5, False, "does not split"), (4, 6, False, "does not split"),
    (2, 6, True, "odd row"), (4, 8, True, None), (2, 6, False, None)])
def test_uneven_and_odd_blocks_are_refused(n, h, stride2, match):
    """A map that n does not split into equal row blocks, or whose blocks
    would start on an odd row in front of a stride-2 op, raises a
    ValueError naming n and the rows (XLA pads uneven shards)."""
    layout = tsp.RowLayout(_fake_mesh(n))
    if match is None:
        assert layout.block(h, stride2) == (0, h // n)
        return
    with pytest.raises(ValueError, match=match) as e:
        layout.block(h, stride2)
    assert f"{n} ranks" in str(e.value) and f"{h}-row" in str(e.value)


def test_world_of_one_is_the_plain_forward():
    """Without a process group the hooks keep their keys and routing but no
    layer runs on rows: the forward is the one with those hooks, and D's
    constraint is the identity."""
    jg, jd = _configs(16)
    tg, td = _port(jg), _port(jd)
    gflat, dflat = _weights(jg, jd)
    gp, dp = tck.flat_to_tree(gflat), tck.flat_to_tree(dflat)
    ws = torch.randn((2, tg.num_ws, 32),
                     generator=torch.Generator().manual_seed(0))
    mesh = tmesh.Mesh(1, 0, torch.device("cpu"))
    fn = tsp.spatial_synthesis_fn(tg, mesh, min_res=8)
    want = tsg.synthesis_apply(tg.synthesis, gp["synthesis"], ws)
    assert torch.equal(fn(gp, ws), want)
    img = torch.randn((2, 3, 16, 16), generator=torch.Generator().manual_seed(1))
    assert torch.equal(
        tsg.discriminator_apply(td, dp, img, spatial_constraint=(
            tsp.d_spatial_constraint(mesh))),
        tsg.discriminator_apply(td, dp, img))


# ----------------------------------------------------------------------------
# Two ranks


@pytest.mark.parametrize("label", [r[0] for r in SYNTH_RUNS])
def test_spatial_synthesis_matches_jax_and_one_process(runs, label):
    """Each rank holds half the image's rows; gathered, the image is the
    one-process forward's and JAX's spatial_synthesis_fn's."""
    for r, out in enumerate(runs["ranks"]):
        img, block = out["synthesis"][label]
        assert block == (2, 3, SYNTH_RES // 2, SYNTH_RES)
        _close(img, runs["one_synth"][label], f"rank {r} vs one process")
    np.testing.assert_array_equal(runs["ranks"][0]["synthesis"][label][0],
                                  runs["ranks"][1]["synthesis"][label][0])
    if label in runs["jax"]:
        _close(runs["ranks"][0]["synthesis"][label][0], runs["jax"][label],
               "vs JAX")


@pytest.mark.parametrize("pair", ["halo", "enter", "gather"])
def test_exchange_is_adjoint_to_its_backward(runs, pair):
    """<A x, y> = <x, A^T y> in float64 over both ranks, A^T the autograd
    backward of the pair's forward Function."""
    for out in runs["ranks"]:
        assert out["probes"]["adjoint"][pair] < 1e-12


@pytest.mark.parametrize("pair", ["halo", "enter", "gather"])
def test_exchange_gradcheck_first_and_second_order(runs, pair):
    """gradcheck and gradgradcheck (float64) of a map of whole tensors
    through the pair, on both ranks."""
    for out in runs["ranks"]:
        assert out["probes"]["gradcheck"][pair] == (True, True)


@pytest.mark.parametrize("what", ["logits", "r1", "grads"])
def test_d_spatial_constraint_matches_d_without_it(runs, what):
    """D with the packed first block at 32^2 on two ranks' rows (blocks of
    32, 16 and 8 rows sharded, the 4x4 epilogue gathered) against D in one
    process: logits, R1 per sample and R1's gradient of every D leaf, the
    ranks bit-equal."""
    want = runs["one_d"][what]
    got = [out["d"][what] for out in runs["ranks"]]
    if what == "grads":
        assert set(got[0]) == set(want)
        for k, v in want.items():
            _close(got[0][k], v, k)
            np.testing.assert_array_equal(got[0][k], got[1][k])
        return
    _close(got[0], want, what)
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("variant", VARIANTS)
def test_spatial_step_ranks_are_bit_equal(runs, variant):
    a, b = (r["step"][variant]["state"] for r in runs["ranks"])
    assert set(a) == set(b)
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


@pytest.mark.parametrize("variant", VARIANTS)
def test_spatial_step_matches_one_process_step(runs, variant):
    """Every leaf of the state (parameters, G_ema, both Adam moments,
    pl_mean, w_avg, ada_p) and every metric; the exchanges ran."""
    assert runs["kinks"][variant] == [], (
        "the inputs lie at a kink of the step's gradient")
    got, want = runs["ranks"][0]["step"][variant], runs["one"][variant]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        _close(got["metrics"][k], v, k)
    assert set(got["state"]) == set(want["state"])
    for k, v in want["state"].items():
        if isinstance(v, torch.Tensor):
            _close(got["state"][k], v, k)
        else:
            assert got["state"][k] == v, k
    moved = [k for k, v in want["state"].items()
             if k.startswith("g_opt_state/mu") and bool(v.abs().max())]
    assert len(moved) > 10
    stats = runs["ranks"][0]["stats"]
    assert stats["halo"] > 0 and stats["enter"] > 0 and stats["gather"] > 0


# ----------------------------------------------------------------------------
# Against JAX's sharded step


@pytest.mark.slow
def test_spatial_step_matches_jax_spatial_step():
    """The three variants on two ranks against JAX's make_fused_step with
    spatial_sharding_hooks (min_res 8) and d_spatial_constraint over
    create_mesh(2), jitted, from the same weights and key; the ranks replay
    JAX's draws."""
    sg, sd = _configs(STEP_RES, packed_first_block=True)
    gflat, dflat = _weights(sg, sd)
    rng = np.random.RandomState(7)
    real = rng.uniform(-1, 1, (4, 3, STEP_RES, STEP_RES)).astype(np.float32)
    z = rng.randn(4, 32).astype(np.float32)
    key = jax.random.PRNGKey(12)
    rec = RecordingRng(JaxRng(key))
    dryrun.run_variants(None, *_step_case(rec, real, z, (gflat, dflat)).build(
        None, "cpu"), VARIANTS)
    ranks = tmesh.spawn(
        dryrun.spatial_rank, 2, devices="cpu", timeout=TIMEOUT,
        limit=4 * TIMEOUT,
        args=(dryrun.SpatialCase(step=_step_case(rec.replay(), real, z,
                                                 (gflat, dflat))),))
    jcfg = jts.TrainConfig(**STEP_CFG, loss=jgl.GANLossConfig(**STEP_LOSS))
    mesh = create_mesh(2)
    hooks = jsp.spatial_sharding_hooks(sg.synthesis, mesh, min_res=8)
    augment_fn = jaug.make_augment_fn(jaug.make_config("bgc"))
    for name, do_g, do_d in dryrun.VARIANTS:
        jgp, jdp = jck.flat_to_tree(gflat), jck.flat_to_tree(dflat)
        g_tx, d_tx, _, _ = jts.build_optimizers(jcfg, jgp, jdp)
        state = place_state(mesh, jts.init_train_state(
            jcfg, jgp, jdp, g_tx, d_tx).replace(ada_p=jnp.float32(0.6)))
        step = jax.jit(jts.make_fused_step(
            jcfg, sg, sd, g_tx, d_tx, augment_fn=augment_fn, do_g_reg=do_g,
            do_d_reg=do_d, extra_hooks=hooks,
            d_constraint=jsp.d_spatial_constraint(mesh)))
        jstate, jmetrics = step(state, jnp.asarray(real), None,
                                jnp.asarray(z), None, key)
        got = ranks[0]["step"][name]
        for k, v in jmetrics.items():
            _close(got["metrics"][k], np.asarray(v), k)
        for tree in ("g_params", "d_params", "g_ema"):
            for k, v in jck.tree_to_flat(getattr(jstate, tree)).items():
                leaf = f"{tree}/" + k.replace(".", "/")
                _close(got["state"][leaf], np.asarray(v), leaf)
        _close(got["state"]["pl_mean"], np.asarray(jstate.pl_mean),
               "pl_mean")
