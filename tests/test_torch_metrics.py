"""The port's metric stack (gagan_tpu_torch/metrics/{fid,kid,
precision_recall,inception_score,feature_stats,ppl,metric_main}.py)
against the JAX package's.

* On seeded features: FID and KID run the same float64 numpy code, so they
  must be equal within float64 rounding; precision and recall may differ by
  1/N where a distance lies on a threshold within fp32 rounding; IS equal.
* ``FeatureStats``: mean and covariance, and cache files written by either
  package's ``save`` load in the other (and the dataset loop finds the
  other's cache file by name).
* On tests/test_metrics.py's tiny generator (16^2, 16 channels) and 24
  random PNGs, with JAX's key tree injected (``JaxRng``): generator
  features (random noise) 2e-4 of max; FID, KID and PPL rtol 1e-3; the
  registry's ``fid1k`` / ``kid1k`` through ``calc_metric``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.data import ImageFolderDataset as JDataset
from gagan_tpu.metrics import feature_stats as jfs
from gagan_tpu.metrics import fid as jfid
from gagan_tpu.metrics import inception_score as jis
from gagan_tpu.metrics import kid as jkid
from gagan_tpu.metrics import metric_main as jmm
from gagan_tpu.metrics import ppl as jppl
from gagan_tpu.metrics import precision_recall as jpr
from gagan_tpu.metrics.detectors import Detector as JDetector
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.data import ImageFolderDataset as TDataset
from gagan_tpu_torch.metrics import feature_stats as tfs
from gagan_tpu_torch.metrics import fid as tfid
from gagan_tpu_torch.metrics import inception_score as tis
from gagan_tpu_torch.metrics import kid as tkid
from gagan_tpu_torch.metrics import metric_main as tmm
from gagan_tpu_torch.metrics import ppl as tppl
from gagan_tpu_torch.metrics import precision_recall as tpr
from gagan_tpu_torch.metrics.detectors import Detector as TDetector
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.ops.resize import resize2d
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils.png import write_png
from .test_torch_augment import JaxRng

torch.set_num_threads(2)

TINY = dict(z_dim=16, w_dim=16, img_resolution=16, img_channels=3)
_W = np.random.RandomState(0).randn(48, 8).astype(np.float32)


def toy_detectors(name="toy"):
    """tests/test_metrics.py's toy detector in both packages: pixels
    resized to 4x4 (antialiased bilinear), projected to 8 features."""
    def jfn(images):
        x = images.astype(jnp.float32) / 255.0
        x = jax.image.resize(x, x.shape[:2] + (4, 4), method="bilinear")
        return x.reshape(x.shape[0], -1) @ jnp.asarray(_W)

    def tfn(images):
        x = resize2d(images.float() / 255.0, (4, 4), "bilinear")
        return x.reshape(x.shape[0], -1) @ torch.from_numpy(_W)

    return JDetector(name, jfn, 8), TDetector(name, tfn, 8)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    for i in range(24):
        write_png(str(d / f"i{i:03d}.png"),
                  rng.randint(0, 255, (16, 16, 3), np.uint8))
    jcfg = jsg.GeneratorConfig(
        **TINY, mapping=jsg.MappingConfig(num_layers=1),
        synthesis=jsg.SynthesisConfig(channel_base=256, channel_max=16))
    tcfg = tsg.GeneratorConfig(
        **TINY, mapping=tsg.MappingConfig(num_layers=1),
        synthesis=tsg.SynthesisConfig(channel_base=256, channel_max=16))
    flat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0), jcfg))
    # Non-zero noise strengths, so the injected noise draws matter.
    flat = {k: (np.float32(0.3) if k.endswith("noise_strength") else v)
            for k, v in flat.items()}
    return (jcfg, jck.flat_to_tree(flat), JDataset(str(d)), tcfg,
            tck.flat_to_tree(flat), TDataset(str(d)))


def _opts(tiny, cache_dir=None, name="toy", batch=8, seed=0):
    jcfg, jp, jdata, tcfg, tp, tdata = tiny
    jdet, tdet = toy_detectors()
    jo = jfs.MetricOptions(g_params=jp, g_cfg=jcfg, dataset=jdata,
                           detectors={name: jdet}, batch_size=batch,
                           cache_dir=cache_dir, rng_seed=seed)
    to = tfs.MetricOptions(g_params=tp, g_cfg=tcfg, dataset=tdata,
                           detectors={name: tdet}, batch_size=batch,
                           cache_dir=cache_dir, rng_seed=seed, device="cpu",
                           rng=JaxRng(jax.random.PRNGKey(seed)))
    return jo, to


def _features(seed, n=200, d=16, shift=0.0):
    return (np.random.RandomState(seed).randn(n, d) + shift).astype(
        np.float32)


# ----------------------------------------------------------------------------
# On seeded features


def test_fid_and_kid_equal_jax():
    real, gen = _features(1), _features(2, n=150, shift=0.3)
    stats = []
    for x in (real, gen):
        s = tfs.FeatureStats(capture_mean_cov=True)
        s.append(x)
        stats += list(s.get_mean_cov())
    want = jfid.frechet_distance(*stats)
    assert tfid.frechet_distance(*stats) == want
    for size in (50, 1000):
        assert tkid.kid_from_features(real, gen, 7, size, seed=3) == \
            jkid.kid_from_features(real, gen, 7, size, seed=3)


def test_feature_stats_mean_cov():
    x = _features(3, n=500, d=8)
    stats = tfs.FeatureStats(capture_mean_cov=True, capture_all=True,
                             max_items=450)
    for i in range(0, 500, 64):
        stats.append(torch.from_numpy(x[i:i + 64]))
    assert stats.is_full() and stats.num_items == 450
    mean, cov = stats.get_mean_cov()
    np.testing.assert_allclose(mean, x[:450].mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cov, np.cov(x[:450].T, bias=True), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(stats.get_all(), x[:450])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cache_files_load_across_packages(tmp_path, writer):
    x = _features(4, n=40, d=8)
    src, dst = (jfs, tfs) if writer == "jax" else (tfs, jfs)
    s = src.FeatureStats(capture_all=True, capture_mean_cov=True,
                         max_items=30)
    s.append(x)
    path = str(tmp_path / "stats.pkl")
    s.save(path)
    loaded = dst.FeatureStats.load(path)
    assert vars(loaded).keys() == vars(s).keys()
    np.testing.assert_array_equal(loaded.get_all(), x[:30])
    for a, b in zip(loaded.get_mean_cov(), s.get_mean_cov()):
        np.testing.assert_array_equal(a, b)


def test_precision_recall_within_one_sample_of_jax():
    real = _features(5, d=8)
    for gen in (real[:100] + 0.01 * _features(6, n=100, d=8),
                _features(7, n=120, d=8, shift=1.0)):
        want = jpr.knn_precision_recall(real, gen, row_batch_size=64)
        got = tpr.knn_precision_recall(real, gen, row_batch_size=64,
                                       device="cpu")
        assert abs(got[0] - want[0]) <= 1 / len(gen)
        assert abs(got[1] - want[1]) <= 1 / len(real)
    assert got[0] < 1.0


def test_inception_score_equals_jax():
    p = np.random.RandomState(8).dirichlet(np.ones(10) * 0.3, size=100)
    assert tis.is_from_probs(p, 5) == jis.is_from_probs(p, 5)
    mean, _ = tis.is_from_probs(np.full((40, 10), 0.1), 2)
    np.testing.assert_allclose(mean, 1.0, rtol=1e-6)


# ----------------------------------------------------------------------------
# On the tiny generator and dataset


def _close(got, want, tol=2e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_generator_and_dataset_features_match_jax(tiny):
    jo, to = _opts(tiny)
    want = jfs.compute_feature_stats_for_generator(
        jo, "toy", capture_all=True, max_items=20).get_all()
    got = tfs.compute_feature_stats_for_generator(
        to, "toy", capture_all=True, max_items=20).get_all()
    assert got.shape == want.shape == (20, 8)
    _close(got, want)
    want = jfs.compute_feature_stats_for_dataset(
        jo, "toy", capture_all=True, max_items=20).get_all()
    got = tfs.compute_feature_stats_for_dataset(
        to, "toy", capture_all=True, max_items=20).get_all()
    _close(got, want)


def test_fid_kid_and_shared_cache_match_jax(tiny, tmp_path):
    """compute_fid / compute_kid on 16 generated and 24 real images; the
    port finds the dataset statistics JAX cached, under the same name."""
    cache = str(tmp_path / "cache")
    jo, to = _opts(tiny, cache_dir=cache)
    want = jfid.compute_fid(jo, max_real=24, num_gen=16, detector_name="toy")
    files = os.listdir(cache)
    assert len(files) == 1 and files[0].startswith(f"{tiny[2].name}-toy-")
    got = tfid.compute_fid(to, max_real=24, num_gen=16, detector_name="toy")
    assert os.listdir(cache) == files
    np.testing.assert_allclose(got, want, rtol=1e-3)
    jo, to = _opts(tiny, seed=1)
    want = jkid.compute_kid(jo, max_real=24, num_gen=16, num_subsets=5,
                            max_subset_size=12, detector_name="toy")
    got = tkid.compute_kid(to, max_real=24, num_gen=16, num_subsets=5,
                           max_subset_size=12, detector_name="toy")
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("space,sampling,crop", [
    ("w", "end", False), ("z", "full", True)])
def test_ppl_matches_jax(tiny, space, sampling, crop):
    """compute_ppl with JAX's draws (z0, z1, t and the shared noise key),
    G in fp32, the toy detector for the LPIPS embedding."""
    jo, to = _opts(tiny, name="toy_lpips")
    kw = dict(num_samples=16, space=space, sampling=sampling, crop=crop,
              detector_name="toy_lpips")
    want = jppl.compute_ppl(jo, **kw)
    got = tppl.compute_ppl(to, **kw)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_slerp_matches_jax():
    a, b = _features(9, n=4), _features(10, n=4)
    t = np.linspace(0, 1, 4, dtype=np.float32)[:, None]
    want = jppl.slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))
    got = tppl.slerp(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(t))
    _close(got, want, 1e-6)


def test_registry_and_calc_metric_match_jax(tiny, tmp_path):
    assert tmm.list_valid_metrics() == jmm.list_valid_metrics()
    for name in ("fid50k_full", "fid3k", "kid5k", "kid3k", "ppl2_wend",
                 "ppl_zfull", "pr50k3", "is50k", "nope", "pr3k", "fid3"):
        assert tmm.is_valid_metric(name) == jmm.is_valid_metric(name), name
    jcfg, jp, jdata, tcfg, tp, tdata = tiny
    jdet, tdet = toy_detectors("inception")
    for metric in ("fid1k", "kid1k"):
        want = jmm.calc_metric(metric, g_params=jp, g_cfg=jcfg,
                               dataset=jdata, detectors={"inception": jdet},
                               batch_size=100)
        got = tmm.calc_metric(metric, g_params=tp, g_cfg=tcfg, dataset=tdata,
                              detectors={"inception": tdet}, batch_size=100,
                              device="cpu",
                              rng=JaxRng(jax.random.PRNGKey(0)))
        assert got.keys() == want.keys() and got["num_gpus"] == 1
        np.testing.assert_allclose(got["results"][metric],
                                   want["results"][metric], rtol=1e-3)
    tmm.report_metric(got, run_dir=str(tmp_path),
                      snapshot_pkl=str(tmp_path / "snap.npz"))
    import json

    with open(tmp_path / "metric-kid1k.jsonl") as f:
        line = json.loads(f.read())
    assert line["snapshot_pkl"] == "snap.npz" and set(line) == {
        "results", "metric", "total_time", "total_time_str", "num_gpus",
        "snapshot_pkl", "timestamp"}


# ----------------------------------------------------------------------------
# CLIP quality and diversity


def test_clip_quality_diversity_matches_jax():
    from gagan_tpu.metrics import clip_eval as jce
    from gagan_tpu_torch.metrics import clip_eval as tce

    emb = _features(11, n=12, d=32)
    for target in (_features(12, n=1, d=32)[0], _features(13, n=3, d=32)):
        want = jce.clip_quality_diversity(jnp.asarray(emb),
                                          jnp.asarray(target))
        got = tce.clip_quality_diversity(torch.from_numpy(emb),
                                         torch.from_numpy(target))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_clip_evaluate_generator_matches_jax(tiny):
    """evaluate_generator on the tiny G (truncation 0.7, random noise from
    JAX's keys) with a 2-layer CLIP of width 64 crossed as numpy."""
    from gagan_tpu.clip import model as jclip
    from gagan_tpu.metrics import clip_eval as jce
    from gagan_tpu_torch.clip import model as tclip
    from gagan_tpu_torch.metrics import clip_eval as tce

    jcfg, jp, _, tcfg, tp, _ = tiny
    kw = dict(embed_dim=32, image_resolution=32, vision_layers=2,
              vision_width=64, vision_patch_size=8, transformer_width=32,
              transformer_heads=4, transformer_layers=2,
              vision_heads_override=4)
    ccj, cct = jclip.CLIPConfig(**kw), tclip.CLIPConfig(**kw)
    flat = jck.tree_to_flat(jclip.init_clip(jax.random.PRNGKey(1), ccj))
    target = _features(14, n=1, d=32)[0]
    key = jax.random.PRNGKey(5)
    want = jce.evaluate_generator(
        jce.CLIPEvalConfig(data_size=10, batch_size=4), jcfg, jp, ccj,
        jck.flat_to_tree(flat), jnp.asarray(target), key)
    got = tce.evaluate_generator(
        tce.CLIPEvalConfig(data_size=10, batch_size=4), tcfg, tp, cct,
        tck.flat_to_tree(flat), torch.from_numpy(target), JaxRng(key))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5)


def test_reference_fault_sqrtm_disp_is_gone_from_newer_scipy():
    """A fault of the JAX package: gagan_tpu/metrics/fid.py:13 calls
    ``scipy.linalg.sqrtm(..., disp=False)``.  SciPy deprecates ``disp`` and
    drops it in 1.18 (here it warns so); there every FID of the JAX package
    stops with a TypeError (the port met it on the card's SciPy).  The
    port calls ``sqrtm`` without it and gets the same root."""
    import warnings

    real, gen = _features(15, n=40, d=6), _features(16, n=40, d=6, shift=1)
    stats = [v for x in (real, gen)
             for v in (x.mean(0), np.cov(x.T, bias=True))]
    with pytest.warns(DeprecationWarning, match="disp"):
        want = jfid.frechet_distance(*stats)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        got = tfid.frechet_distance(*stats)
    assert got == want
