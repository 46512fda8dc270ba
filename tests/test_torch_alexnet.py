"""The port's AlexNet-LPIPS (gagan_tpu_torch/metrics/alexnet.py) and the
GA's pairwise LPIPS fn against the JAX package's, on weights drawn here
from a numpy seed (He scales, so the taps stay of order one; positive lin
weights; the lpips scaling constants) and crossed as numpy with the JAX
package's flat keys.  Tolerance 2e-4 of max|JAX|, the suite's forward
tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.ga import evaluation as jev
from gagan_tpu.metrics import alexnet as jalex
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.ga import evaluation as tev
from gagan_tpu_torch.metrics import alexnet as talex
from gagan_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)


def alex_flat(seed=0, scaling=True):
    rng = np.random.default_rng(seed)
    flat = {}
    for idx, (cin, cout, k, _, _) in jalex.ALEX_CONVS.items():
        flat[f"features.{idx}.weight"] = rng.standard_normal(
            (cout, cin, k, k), dtype=np.float32) * np.float32(
                np.sqrt(2 / (cin * k * k)))
        flat[f"features.{idx}.bias"] = rng.standard_normal(
            cout, dtype=np.float32) * np.float32(0.1)
    for i, c in enumerate(jalex.LPIPS_CHANNELS):
        flat[f"lin.{i}.weight"] = np.abs(rng.standard_normal(
            c, dtype=np.float32)) * np.float32(0.1)
    if scaling:
        flat["scaling.shift"] = np.array([-0.030, -0.088, -0.188], np.float32)
        flat["scaling.scale"] = np.array([0.458, 0.448, 0.450], np.float32)
    return flat


def _images(seed, n=3, res=64):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 3, res, res)
                                               ).astype(np.float32)


def _close(got, want, tol=2e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("res,scaling", [(64, True), (99, False)])
def test_lpips_distance_matches_jax(res, scaling):
    """Per-pair distances at 64^2 (tap maps 15, 7, 3, 3, 3) and at an odd
    99^2 (the pools' floor), with the scaling leaves and without them (the
    module's constants)."""
    flat = alex_flat(1, scaling)
    jp, tp = jck.flat_to_tree(flat), tck.flat_to_tree(flat)
    a, b = _images(2, res=res), _images(3, res=res)
    want = jalex.lpips_distance(jp, jnp.asarray(a), jnp.asarray(b))
    got = talex.lpips_distance(tp, torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == (3,)
    _close(got, want)
    assert float(talex.lpips_distance(tp, torch.from_numpy(a),
                                      torch.from_numpy(a)).abs().max()) == 0


def test_taps_match_jax():
    flat = alex_flat(2)
    jp, tp = jck.flat_to_tree(flat), tck.flat_to_tree(flat)
    x = _images(4)
    want = jalex.alexnet_taps(jp, jnp.asarray(x))
    got = talex.alexnet_taps(tp, torch.from_numpy(x))
    assert [tuple(t.shape[1:]) for t in got] == [
        (64, 15, 15), (192, 7, 7), (384, 3, 3), (256, 3, 3), (256, 3, 3)]
    for g, w in zip(got, want):
        _close(g, w)


def test_lpips_embedding_matches_jax_and_the_distance():
    """The embedding's squared L2 distance is the LPIPS distance."""
    flat = alex_flat(3)
    jp, tp = jck.flat_to_tree(flat), tck.flat_to_tree(flat)
    a, b = _images(5), _images(6)
    want = jalex.lpips_embedding(jp, jnp.asarray(a))
    ea = talex.lpips_embedding(tp, torch.from_numpy(a))
    _close(ea, want)
    eb = talex.lpips_embedding(tp, torch.from_numpy(b))
    _close((ea - eb).square().sum(dim=1),
           talex.lpips_distance(tp, torch.from_numpy(a), torch.from_numpy(b)))


def test_make_alex_lpips_and_load_params(tmp_path):
    """The GA's pairwise fn on converted weights (an npz as the converter
    writes it), and with random weights of the real shape."""
    flat = alex_flat(4)
    path = str(tmp_path / "alex.npz")
    np.savez(path, **flat)
    a, b = _images(7), _images(8)
    want = jev.make_alex_lpips(jalex.load_params(path))(jnp.asarray(a),
                                                        jnp.asarray(b))
    got = tev.make_alex_lpips(talex.load_params(path), device="cpu")(
        torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want)
    rand = talex.init_alexnet_lpips(torch.Generator().manual_seed(0))
    shapes = {k: v.shape for k, v in tck.tree_to_flat(rand).items()}
    assert shapes == {k: v.shape for k, v in flat.items()}
    d = tev.make_alex_lpips(device="cpu")(torch.from_numpy(a),
                                          torch.from_numpy(b))
    assert d.shape == (3,) and bool(torch.isfinite(d).all())
