"""The port's GA direction search and GA metrics (gagan_tpu_torch/ga/
{search,evaluation}.py) against the JAX package's, on tests/test_ga.py's
tiny generator (16^2, 16 channels) crossed as numpy, with JAX's key tree
injected (``JaxRng``): the initial population, each generation's z, the
parent draws and every child's crossover and mutation draws are JAX's
numbers, so both runs take the same path as long as the scores sort alike.

Tolerances: history and best direction atol 1e-4, the JAX suite's own
(tests/test_ga.py::test_evolution_batched_matches_scan); a G forward 2e-4
of max|JAX|; FID, KID and LPIPS on the same numpy features rtol 1e-5
(float64 numpy in both; the LPIPS means are float32 sums in either
framework).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.ga import evaluation as jev
from gagan_tpu.ga import search as jsearch
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.models import swin as jswin
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.ga import evaluation as tev
from gagan_tpu_torch.ga import search as tsearch
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.models import swin as tswin
from gagan_tpu_torch.utils import checkpoint as tck
from .test_torch_augment import JaxRng
from .test_torch_swin import hf_state_dict

torch.set_num_threads(2)

TINY = dict(z_dim=16, w_dim=16, img_resolution=16, img_channels=3)


@pytest.fixture(scope="module")
def tiny_g():
    jcfg = jsg.GeneratorConfig(
        **TINY, mapping=jsg.MappingConfig(num_layers=1),
        synthesis=jsg.SynthesisConfig(channel_base=256, channel_max=16))
    tcfg = tsg.GeneratorConfig(
        **TINY, mapping=tsg.MappingConfig(num_layers=1),
        synthesis=tsg.SynthesisConfig(channel_base=256, channel_max=16))
    flat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0), jcfg))
    return jcfg, jck.flat_to_tree(flat), tcfg, tck.flat_to_tree(flat)


def _brightness(pkg):
    if pkg == "jax":
        return lambda img: jnp.mean(img.astype(jnp.float32))
    return lambda img: img.float().mean()


def _swin_fitness():
    """bench_ga_search.py's fitness on a tiny Swin (16^2 images, 4x4
    patches, one stage with a 4x4 window): the pooled features' cosine to a
    fixed unit target, averaged over the candidate's images."""
    kw = dict(image_size=16, embed_dim=16, depths=(2,), num_heads=(2,),
              window_size=4)
    jcfg, tcfg = jswin.SwinConfig(**kw), tswin.SwinConfig(**kw)
    sd = hf_state_dict(tcfg, seed=4)
    jext = jswin.make_feature_extractor(jcfg, jswin.params_from_hf(sd, jcfg))
    text = tswin.make_feature_extractor(tcfg, tswin.params_from_hf(sd, tcfg),
                                        device="cpu")
    target = np.random.RandomState(2).randn(16).astype(np.float32)
    target /= np.linalg.norm(target)

    def jfit(img_u8):
        f = jext(img_u8.astype(jnp.float32) / 127.5 - 1.0)
        f = f / (jnp.linalg.norm(f, axis=-1, keepdims=True) + 1e-8)
        return jnp.mean(f @ jnp.asarray(target))

    def tfit(img_u8):
        f = text(img_u8.float() / 127.5 - 1.0)
        f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-8)
        return (f @ torch.from_numpy(target)).mean()

    return jfit, tfit


def test_zero_direction_equals_no_hooks(tiny_g):
    _, _, tcfg, tp = tiny_g
    dim = tsearch.direction_dim(tcfg.synthesis)
    assert dim == sum(tcfg.synthesis.layer_in_channels())
    z = torch.from_numpy(np.random.RandomState(2).randn(2, 16).astype(
        np.float32))
    hooks = tsearch.direction_to_hooks(tcfg.synthesis, torch.zeros(dim))
    base = tsg.generator_apply(tcfg, tp, z)
    assert torch.equal(tsg.generator_apply(tcfg, tp, z, hooks=hooks), base)


def test_direction_hooks_match_jax(tiny_g):
    """One flat direction (scan) and per-sample rows (batched) move the
    styles as JAX's hooks do."""
    jcfg, jp, tcfg, tp = tiny_g
    dim = tsearch.direction_dim(tcfg.synthesis)
    rng = np.random.RandomState(3)
    z = rng.randn(3, 16).astype(np.float32)
    d = rng.randn(dim).astype(np.float32)
    rows = rng.randn(3, dim).astype(np.float32)
    for jhooks, thooks in (
            (jsearch.direction_to_hooks(jcfg.synthesis, jnp.asarray(d)),
             tsearch.direction_to_hooks(tcfg.synthesis, torch.from_numpy(d))),
            (jsearch.batched_direction_hooks(jcfg.synthesis,
                                             jnp.asarray(rows)),
             tsearch.batched_direction_hooks(tcfg.synthesis,
                                             torch.from_numpy(rows)))):
        want = jsg.generator_apply(jcfg, jp, jnp.asarray(z), hooks=jhooks)
        got = tsg.generator_apply(tcfg, tp, torch.from_numpy(z), hooks=thooks)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("fitness", ["brightness", "swin"])
@pytest.mark.parametrize("mode", ["scan", "batched"])
def test_evolution_matches_jax(tiny_g, mode, fitness):
    jcfg, jp, tcfg, tp = tiny_g
    jfit, tfit = ((_brightness("jax"), _brightness("torch"))
                  if fitness == "brightness" else _swin_fitness())
    base = dict(population=8, generations=3, elite=2, batch_per_candidate=2,
                mutation_rate=0.3, init_sigma=0.5)
    key = jax.random.PRNGKey(1)
    jbest, jhist = jsearch.evolve_directions(
        key, jcfg, jp, jfit, jsearch.GASearchConfig(eval_mode=mode, **base))
    seen = []
    tbest, thist = tsearch.evolve_directions(
        JaxRng(key), tcfg, tp, tfit,
        tsearch.GASearchConfig(eval_mode=mode, **base),
        progress=lambda gen, best: seen.append((gen, best)))
    assert tbest.shape == (tsearch.direction_dim(tcfg.synthesis),)
    assert thist.shape == (3,) and [g for g, _ in seen] == [0, 1, 2]
    np.testing.assert_allclose(thist, jhist, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tbest, jbest, rtol=1e-4, atol=1e-4)


def test_batched_matches_scan(tiny_g):
    """The port's two evaluation modes score each candidate alike, so the
    evolutions agree (the port's own draws, not JAX's)."""
    from gagan_tpu_torch.utils.rng import Rng

    _, _, tcfg, tp = tiny_g
    _, tfit = _swin_fitness()
    base = dict(population=8, generations=2, elite=2, batch_per_candidate=2)
    runs = [tsearch.evolve_directions(
        Rng(7), tcfg, tp, tfit, tsearch.GASearchConfig(eval_mode=m, **base))
        for m in ("scan", "batched")]
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4, atol=1e-4)


def test_next_generation_keeps_the_elite_in_order():
    from gagan_tpu_torch.utils.rng import Rng

    cfg = tsearch.GASearchConfig(population=6, elite=2)
    pop = torch.arange(6, dtype=torch.float32)[:, None].repeat(1, 3)
    scores = torch.tensor([0.1, 0.9, 0.5, 0.9, 0.2, 0.0])
    nxt = tsearch.next_generation(cfg, pop, scores, Rng(0))
    assert nxt.shape == (6, 3)
    # Stable descending sort: of the tied 0.9s, candidate 1 comes first.
    assert torch.equal(nxt[:2], pop[[1, 3]])


def test_mesh_and_unknown_mode_raise(tiny_g):
    """``mesh=``, refused while the port ran on one card, now splits the
    population over the ranks: over two gloo ranks, in either eval mode,
    the history and best direction equal the one-process run's
    (tests/test_ga.py:116-135's rtol 1e-5), and a world of one is the plain
    run.  An unknown eval_mode still raises."""
    from gagan_tpu_torch.parallel import dryrun
    from gagan_tpu_torch.parallel import mesh as tmesh
    from gagan_tpu_torch.utils.rng import Rng

    _, _, tcfg, tp = tiny_g
    cfgs = [tsearch.GASearchConfig(population=16, generations=3, elite=2,
                                   batch_per_candidate=2, eval_mode=mode)
            for mode in ("batched", "scan")]
    ranks = tmesh.spawn(dryrun.ga_rank, 2, devices="cpu", timeout=120,
                        limit=120, args=(tcfg, tck.tree_to_flat(tp), cfgs,
                                         Rng(0)))
    for i, cfg in enumerate(cfgs):
        best, hist = tsearch.evolve_directions(Rng(0), tcfg, tp,
                                               dryrun.contrast_fitness, cfg)
        one = tsearch.evolve_directions(
            Rng(0), tcfg, tp, dryrun.contrast_fitness, cfg,
            mesh=tmesh.create_mesh(device="cpu"))
        np.testing.assert_array_equal(one[0], best)
        for r in ranks:
            np.testing.assert_allclose(r[i]["history"], hist, rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(r[i]["best"], best, rtol=1e-5,
                                       atol=1e-5)
    with pytest.raises(ValueError, match="eval_mode"):
        tsearch.evolve_directions(
            Rng(0), tcfg, tp, _brightness("torch"),
            dataclasses.replace(tsearch.GASearchConfig(), eval_mode="map"))


@pytest.mark.parametrize("lpips", ["pair", "embedding"])
def test_calculate_metrics_matches_jax(lpips):
    """FID (biased covariances), KID (10 subsets of 32) and LPIPS through
    either interface, on the same uint8 images and the same functions."""
    rng = np.random.RandomState(0)
    real = rng.randint(0, 255, (48, 3, 16, 16), np.uint8)
    gen = rng.randint(0, 255, (40, 3, 16, 16), np.uint8)
    w = rng.randn(768, 8).astype(np.float32)

    def feat(images):            # the same numpy features for both
        x = np.asarray(images).astype(np.float32)
        return x.reshape(x.shape[0], -1) / 255.0 @ w

    kw_j, kw_t = {}, {}
    if lpips == "pair":
        kw_j["lpips_pair_fn"] = lambda a, b: jnp.mean(
            jnp.abs(a - b), axis=(1, 2, 3))
        kw_t["lpips_pair_fn"] = lambda a, b: (a - b).abs().mean(dim=(1, 2, 3))
    else:
        kw_j["lpips_fn"] = kw_t["lpips_fn"] = feat
    want = jev.calculate_metrics(jnp.asarray(real), jnp.asarray(gen), feat,
                                 kid_subset_size=32, **kw_j)
    got = tev.calculate_metrics(torch.from_numpy(real), torch.from_numpy(gen),
                                feat, kid_subset_size=32, **kw_t)
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_extract_features_batches():
    kw = dict(image_size=16, embed_dim=16, depths=(2,), num_heads=(2,),
              window_size=4)
    tcfg = tswin.SwinConfig(**kw)
    extract = tswin.make_feature_extractor(
        tcfg, tswin.params_from_hf(hf_state_dict(tcfg, 1), tcfg),
        device="cpu")
    x = torch.from_numpy(np.random.RandomState(4).uniform(
        -1, 1, (5, 3, 16, 16)).astype(np.float32))
    got = tev.extract_features(x, extract, batch_size=2)
    np.testing.assert_allclose(got, extract(x).numpy(), rtol=0, atol=1e-6)
