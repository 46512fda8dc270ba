"""The port's InceptionV3 (gagan_tpu_torch/metrics/inception.py) and its
detectors against the JAX package's, on weights drawn here from a numpy
seed (He-scaled convolutions, batch norms with non-trivial running
statistics) and crossed as numpy with pytorch-fid's keys.

The full network runs at 75^2 with ``resize_input=False``, the smallest
size that passes every stride; the 1024 -> 299 resize (antialiased
bilinear) is checked apart against ``jax.image.resize``.  Tolerance 2e-4
of max|JAX|, the suite's forward tolerance.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.metrics import inception as jinc
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.metrics import detectors as tdet
from gagan_tpu_torch.metrics import inception as tinc
from gagan_tpu_torch.ops.resize import resize2d
from gagan_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def flat():
    """Every leaf of the network, seeded: convs N(0, 2 / fan_in), batch
    norm weight ~1, bias, running mean and a running variance of 0.5-1.5
    (so the fold's eps and every term matter); fc 1/sqrt(2048)."""
    shapes = {k: v.shape for k, v in tck.tree_to_flat(
        tinc.init_inception_v3(torch.Generator().manual_seed(0))).items()}
    rng = np.random.default_rng(0)
    out = {}
    for k, shape in sorted(shapes.items()):
        if k.endswith("conv.weight") or k == "fc.weight":
            fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape, dtype=np.float32) * np.sqrt(
                2.0 / fan_in)
        elif k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("bn.weight"):
            v = 1 + 0.1 * rng.standard_normal(shape)
        else:                               # biases, running means
            v = 0.1 * rng.standard_normal(shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _close(got, want, tol=2e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_network_matches_jax_at_75(flat):
    """Features, logits and biased logits, through every block, with the
    FID patches (pools without the padding in the count, Mixed_7c's max
    pool)."""
    jp, tp = jck.flat_to_tree(flat), tck.flat_to_tree(flat)
    x = np.random.RandomState(1).randint(0, 256, (2, 3, 75, 75), np.uint8)
    want = jinc.inception_v3_features(jp, jnp.asarray(x), resize_input=False,
                                      return_logits=True)
    got = tinc.inception_v3_features(tp, torch.from_numpy(x),
                                     resize_input=False, return_logits=True)
    assert tuple(got[0].shape) == (2, 2048) and tuple(got[1].shape) == (2,
                                                                        1008)
    for g, w in zip(got, want):
        _close(g, w)
    _close(torch.softmax(got[1], dim=1), jax.nn.softmax(want[1], axis=1))


def test_resize_1024_to_299_matches_jax():
    """The input resize: jax.image.resize's antialiased bilinear, which
    F.interpolate does not reproduce."""
    x = np.random.RandomState(2).randint(0, 256, (1, 3, 1024, 1024)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, 3, 299, 299), "bilinear")
    got = resize2d(torch.from_numpy(x), (299, 299), "bilinear")
    _close(got, want)
    plain = torch.nn.functional.interpolate(torch.from_numpy(x), (299, 299),
                                            mode="bilinear")
    assert float((plain - got).abs().max()) > 10


def test_grayscale_input_is_tiled(flat):
    tp = tck.flat_to_tree(flat)
    g = np.random.RandomState(3).randint(0, 256, (1, 1, 75, 75), np.uint8)
    got = tinc.inception_v3_features(tp, torch.from_numpy(g),
                                     resize_input=False)
    want = tinc.inception_v3_features(
        tp, torch.from_numpy(np.repeat(g, 3, axis=1)), resize_input=False)
    assert torch.equal(got, want)


def test_detectors_load_converted_weights(flat, tmp_path, monkeypatch):
    """inception / inception_softmax from GAGAN_DETECTOR_DIR's
    inception_v3.npz (tags of the real weights), equal to JAX's detectors
    on the same file; a set directory without the file raises; unset, the
    random tower of the real shape is tagged."""
    np.savez(tmp_path / "inception_v3.npz", **flat)
    monkeypatch.setenv("GAGAN_DETECTOR_DIR", str(tmp_path))
    from gagan_tpu.metrics import detectors as jdet

    x = np.random.RandomState(4).randint(0, 256, (2, 3, 75, 75), np.uint8)
    for name, tag, dim in (("inception", "inception-2015-12-05", 2048),
                           ("inception_softmax",
                            "inception-2015-12-05-softmax", 1008)):
        det = tdet.make_default(name, "cpu")
        assert (det.name, det.num_features) == (tag, dim)
        jd = jdet.make_default(name)
        assert jd.name == tag
        # resize to 299 on both sides, as the detectors do.
        _close(det(torch.from_numpy(x)), jd(jnp.asarray(x)))
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("GAGAN_DETECTOR_DIR", str(empty))
    with pytest.raises(FileNotFoundError, match="inception_v3.npz"):
        tdet.make_default("inception", "cpu")
    monkeypatch.delenv("GAGAN_DETECTOR_DIR")
    det = tdet.make_default("inception_softmax", "cpu")
    assert det.name == "inception-random-softmax"
    p = det(torch.from_numpy(x[:1]))
    assert tuple(p.shape) == (1, 1008)
    assert float(p.sum()) == pytest.approx(1.0, abs=1e-5)
