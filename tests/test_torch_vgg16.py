"""The port's VGG16 and VGG16-LPIPS (gagan_tpu_torch/metrics/vgg16.py), its
detectors (metrics/detectors.py) and the converter's ``vgg16`` command
against the JAX package's, on weights drawn here from a numpy seed (He
scales, so the activations stay of order one through the 13 convs) and
crossed as numpy with the JAX package's flat keys.

Tolerances, the suite's own: forwards 2e-4 of max|JAX|, gradients 1e-3 of
max|JAX|; conversion copies values, so it is exact.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.metrics import detectors as jdet
from gagan_tpu.metrics import vgg16 as jvgg
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.cli import convert_weights as tcw
from gagan_tpu_torch.metrics import detectors as tdet
from gagan_tpu_torch.metrics import vgg16 as tvgg
from gagan_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def vgg_flat(seed=0, classifier=False):
    """Flat VGG16 (+ lin, + classifier) weights: He-scaled normal convs,
    small biases, positive lin weights."""
    rng = np.random.default_rng(seed)
    flat, idx, in_ch = {}, 0, 3
    for v in jvgg.VGG16_CFG:
        if v == "M":
            idx += 1
            continue
        flat[f"features.{idx}.weight"] = rng.standard_normal(
            (v, in_ch, 3, 3), dtype=np.float32) * float(
                np.sqrt(2 / (9 * in_ch)))
        flat[f"features.{idx}.bias"] = rng.standard_normal(
            v, dtype=np.float32) * 0.1
        in_ch, idx = v, idx + 2
    for i, c in enumerate(jvgg.LPIPS_CHANNELS):
        flat[f"lin.{i}.weight"] = np.abs(rng.standard_normal(
            c, dtype=np.float32)) * 0.1
    if classifier:
        for name, fan_in in (("0", 512 * 7 * 7), ("3", 4096)):
            flat[f"classifier.{name}.weight"] = rng.standard_normal(
                (4096, fan_in), dtype=np.float32) * float(np.sqrt(2 / fan_in))
            flat[f"classifier.{name}.bias"] = rng.standard_normal(
                4096, dtype=np.float32) * 0.1
    return flat


@pytest.fixture(scope="module")
def weights():
    flat = vgg_flat(0)
    return jck.flat_to_tree(flat), tck.flat_to_tree(flat)


def _images(seed, n, c, res):
    return np.random.RandomState(seed).uniform(0, 255, (n, c, res, res)
                                               ).astype(np.float32)


def _close(got, want, tol=2e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("channels,res,resize", [
    (3, 64, True), (1, 40, True), (3, 224, True), (3, 48, False)])
def test_preprocess_matches_jax(channels, res, resize):
    img = _images(1, 2, channels, res)
    want = jvgg.preprocess(jnp.asarray(img), resize=resize)
    got = tvgg.preprocess(torch.from_numpy(img), resize=resize)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("res", [32, 64])
def test_lpips_embedding_matches_jax(weights, res):
    jp, tp = weights
    img = _images(2, 2, 3, res)
    want = jvgg.vgg16_lpips(jp, jnp.asarray(img))
    got = tvgg.vgg16_lpips(tp, torch.from_numpy(img))
    assert tuple(got.shape) == want.shape
    _close(got, want)
    # Taps of the backbone, one by one.
    x = jvgg.preprocess(jnp.asarray(img), resize=False)
    _, jtaps = jvgg.vgg16_backbone(jp, x, collect_taps=True)
    _, ttaps = tvgg.vgg16_backbone(tp, torch.from_numpy(np.asarray(x)),
                                   collect_taps=True)
    assert len(ttaps) == len(jtaps) == 5
    for g, w in zip(ttaps, jtaps):
        _close(g, w)


def test_lpips_gradients_match_jax(weights):
    """d <embedding(a) - embedding(b), r>^2 / d a: the gradient the
    projector and lpips_rec take through the tower."""
    jp, tp = weights
    a, b = _images(3, 2, 3, 32), _images(4, 2, 3, 32)
    emb_b = jvgg.vgg16_lpips(jp, jnp.asarray(b))
    want = jax.grad(lambda x: jnp.sum(jnp.square(
        jvgg.vgg16_lpips(jp, x) - emb_b)))(jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_(True)
    tb = tvgg.vgg16_lpips(tp, torch.from_numpy(b))
    (tvgg.vgg16_lpips(tp, x) - tb).square().sum().backward()
    _close(x.grad, want, 1e-3)


def test_features_match_jax():
    flat = vgg_flat(5, classifier=True)
    img = _images(6, 1, 3, 48)
    want = jvgg.vgg16_features(jck.flat_to_tree(flat), jnp.asarray(img))
    got = tvgg.vgg16_features(tck.flat_to_tree(flat), torch.from_numpy(img))
    assert tuple(got.shape) == want.shape == (1, 4096)
    _close(got, want)


def test_init_shapes_match_jax():
    shapes = jax.eval_shape(lambda: jvgg.init_vgg16(jax.random.PRNGKey(0)))
    want = {".".join(str(p.key) for p in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {k: tuple(v.shape) for k, v in tck.tree_to_flat_tensors(
        tvgg.init_vgg16(torch.Generator().manual_seed(0))).items()}
    assert got == want
    lean = tvgg.init_vgg16(torch.Generator().manual_seed(0),
                           with_classifier=False)
    full = tvgg.init_vgg16(torch.Generator().manual_seed(0))
    assert "classifier" not in lean
    for k, v in tck.tree_to_flat_tensors(lean).items():
        assert torch.equal(v, tck.tree_to_flat_tensors(full)[k]), k


# ----------------------------------------------------------------------------
# Detectors and the converter


@pytest.fixture(scope="module")
def tool():
    """tools/convert_weights.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "convert_weights_tool", os.path.join(REPO, "tools",
                                             "convert_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _torchvision_sd(seed):
    """A torchvision VGG16 state dict (features.N / classifier.N keys; the
    features at their real shapes, the classifier small) and the LPIPS
    package's lin file."""
    flat = vgg_flat(seed)
    rng = np.random.default_rng(seed)
    for i, shape in ((0, (16, 32)), (3, (16, 16)), (6, (10, 16))):
        flat[f"classifier.{i}.weight"] = rng.standard_normal(
            shape, dtype=np.float32)
        flat[f"classifier.{i}.bias"] = rng.standard_normal(
            shape[0], dtype=np.float32)
    sd = {k: torch.from_numpy(v) for k, v in flat.items()
          if not k.startswith("lin.")}
    lin = {f"lin{i}.model.1.weight": torch.from_numpy(
        flat[f"lin.{i}.weight"]).reshape(1, -1, 1, 1) for i in range(5)}
    return flat, sd, lin


def test_vgg16_command_matches_the_tool(tool, tmp_path, monkeypatch):
    """The port's command writes the npz the JAX tool writes from the same
    state dicts (the same keys, in the same order, bit-equal arrays), and
    the port's detector loads it."""
    flat, sd, lin = _torchvision_sd(7)
    src, lin_src = str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth")
    torch.save(sd, src)
    torch.save(lin, lin_src)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    tcw.main(["vgg16", "--src", src, "--dest", str(ours / "vgg16.npz"),
              "--lpips-lin", lin_src])
    tool.convert_vgg16(src, str(theirs / "vgg16.npz"), lin_src)
    with np.load(ours / "vgg16.npz") as a, np.load(theirs / "vgg16.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
            np.testing.assert_array_equal(a[k], flat[k], err_msg=k)
    monkeypatch.setenv("GAGAN_DETECTOR_DIR", str(ours))
    det = tdet.make_default("vgg16_lpips", "cpu")
    assert det.name == "vgg16-lpips"
    img = _images(8, 1, 3, 32)
    want = jvgg.vgg16_lpips(jck.flat_to_tree(flat), jnp.asarray(img))
    _close(det(torch.from_numpy(img)), want)
    assert tdet.make_default("vgg16", "cpu").name == "vgg16"


def test_detectors_random_and_refusals(tmp_path, monkeypatch):
    monkeypatch.delenv("GAGAN_DETECTOR_DIR", raising=False)
    det = tdet.make_default("vgg16_lpips", "cpu")
    assert det.name == "vgg16-lpips-random" and det.num_features == -1
    emb = det(torch.from_numpy(_images(9, 2, 3, 32)))
    # Per tap, every channel at every position (relu1_2 at 32^2 ... relu5_3
    # at 2^2).
    assert emb.shape == (2, sum(c * (32 >> i) ** 2 for i, c in
                                enumerate(jvgg.LPIPS_CHANNELS)))
    assert bool(torch.isfinite(emb).all())
    # Inception-v3 is ported now (tests/test_torch_inception.py): random
    # weights of the real shape, tagged.
    assert tdet.make_default("inception", "cpu").name == "inception-random"
    with pytest.raises(ValueError, match="Unknown detector"):
        tdet.make_default("alexnet", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdet.make_default("vgg16_lpips")


def test_reference_fault_detector_dir_without_the_file(tmp_path,
                                                       monkeypatch):
    """A fault of the JAX package: with GAGAN_DETECTOR_DIR naming a
    directory that lacks vgg16.npz, make_default silently returns random
    weights (gagan_tpu/metrics/detectors.py:34-41), so a misplaced file
    goes unnoticed.  The port raises instead."""
    monkeypatch.setenv("GAGAN_DETECTOR_DIR", str(tmp_path))
    assert jdet.make_default("vgg16_lpips").name == "vgg16-lpips-random"
    with pytest.raises(FileNotFoundError, match="vgg16.npz"):
        tdet.make_default("vgg16_lpips", "cpu")
