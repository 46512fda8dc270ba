"""The port's pSp / e4e encoders (gagan_tpu_torch/inversion/encoders.py) and
``inference.project_e4e`` against the JAX package's, on weights drawn here
from a numpy seed in the JAX init's tree (He-scaled convs, batch norms with
non-trivial running statistics) and crossed as numpy with its flat keys.

The encoder is the full IR-SE-50 backbone with FPN style heads at
``coarse_ind`` 1 and ``middle_ind`` 2 of a 4-layer W+, so that every head
level (16, 32 and 64) runs with few heads; inputs are 64^2 (the backbone's
taps at 16, 8 and 4), plus one 256^2 case through ``project_e4e``.
Tolerances, the suite's own: forwards 2e-4 of max|JAX|, gradients 1e-3 of
max|JAX|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu import inference as jinf
from gagan_tpu.inversion import encoders as jenc
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch import inference as tinf
from gagan_tpu_torch.inversion import encoders as tenc
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils.config import generator_config_from_dict

torch.set_num_threads(2)

JCFG = jenc.EncoderConfig(stylegan_size=8, coarse_ind=1, middle_ind=2)
TCFG = tenc.EncoderConfig(**dataclasses.asdict(JCFG))


def _flat_shapes(cfg):
    shapes = jax.eval_shape(lambda: jenc.init_encoder(jax.random.PRNGKey(0),
                                                      cfg))
    return {".".join(str(p.key) for p in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def encoder_flat(seed=0, cfg=JCFG):
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    flat = {}
    for k, shape in _flat_shapes(cfg).items():
        leaf = k.rsplit(".", 1)[1]
        if leaf == "running_var":
            flat[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif leaf == "running_mean" or leaf == "bias":
            flat[k] = normal(shape, 0.1)
        elif len(shape) == 4:                                 # conv weights
            flat[k] = normal(shape, np.sqrt(1.0 / np.prod(shape[1:])))
        elif ".linear." in k:
            flat[k] = normal(shape, 1.0)
        elif ".res_layer.2." in k or k.startswith("input_layer.2"):  # PReLU
            flat[k] = rng.uniform(0.1, 0.4, shape).astype(np.float32)
        else:                                                 # BN scales
            flat[k] = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def weights():
    flat = encoder_flat(0)
    return jck.flat_to_tree(flat), tck.flat_to_tree(flat)


def _x(seed, n=2, res=64):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 3, res, res)
                                               ).astype(np.float32)


def _close(got, want, tol=2e-4):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_init_matches_jax_tree():
    cfg = jenc.EncoderConfig(stylegan_size=32)
    got = {k: tuple(v.shape) for k, v in tck.tree_to_flat_tensors(
        tenc.init_encoder(torch.Generator().manual_seed(0),
                          tenc.EncoderConfig(stylegan_size=32))).items()}
    assert got == _flat_shapes(cfg)
    assert tenc.EncoderConfig().style_count == 18
    assert [b for b in tenc.ir50_blocks()] == jenc.ir50_blocks()


def test_backbone_taps_match_jax(weights):
    jp, tp = weights
    x = _x(1)
    want = jax.jit(lambda p, x: jenc.backbone_features(p, x, True))(
        jp, jnp.asarray(x))
    got = tenc.backbone_features(tp, torch.from_numpy(x), want_final=True)
    assert sorted(got) == sorted(want) == ["c1", "c2", "c3", "final"]
    assert [tuple(got[k].shape[1:]) for k in ("c1", "c2", "c3")] == [
        (128, 16, 16), (256, 8, 8), (512, 4, 4)]
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("kind,stage", [("psp", None), ("e4e", None),
                                        ("e4e", 1)])
def test_encoders_match_jax(weights, kind, stage):
    jp, tp = weights
    x = _x(2)
    if kind == "psp":
        want = jax.jit(lambda p, x: jenc.psp_encode(JCFG, p, x))(
            jp, jnp.asarray(x))
        got = tenc.psp_encode(TCFG, tp, torch.from_numpy(x))
    else:
        want = jax.jit(lambda p, x: jenc.e4e_encode(JCFG, p, x, stage))(
            jp, jnp.asarray(x))
        got = tenc.e4e_encode(TCFG, tp, torch.from_numpy(x), stage)
    assert tuple(got.shape) == (2, JCFG.style_count, 512)
    _close(got, want)


def test_e4e_gradients_match_jax(weights):
    """The input's gradient of <e4e(x), r>: what the DiFa step takes through
    the frozen encoder."""
    jp, tp = weights
    x = _x(3)
    r = np.random.RandomState(4).randn(2, JCFG.style_count, 512).astype(
        np.float32)
    want = jax.jit(jax.grad(lambda x, p: jnp.sum(
        jenc.e4e_encode(JCFG, p, x) * r)))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    (tenc.e4e_encode(TCFG, tp, tx) * torch.from_numpy(r)).sum().backward()
    _close(tx.grad, want, 1e-3)
    for t in tck.tree_to_flat_tensors(tp).values():
        assert t.grad is None


@pytest.mark.parametrize("shape", [(300, 200, 3), (3, 64, 96), (80, 80)])
def test_preprocess_image_matches_jax(shape):
    img = np.random.RandomState(5).randint(0, 256, shape, np.uint8)
    want = jinf.preprocess_image(img)
    got = tinf.preprocess_image(img)
    _close(got, want)


def test_project_e4e_matches_jax(weights):
    """One 256^2 case: a 300x200 image through preprocess_image, e4e and
    a 4-layer G with w_dim 512 (the encoder's width), with latent_avg; and
    an image batch as given."""
    jp, tp = weights
    jg = jsg.GeneratorConfig(
        z_dim=16, w_dim=512, img_resolution=8,
        mapping=jsg.MappingConfig(num_layers=1),
        synthesis=jsg.SynthesisConfig(channel_base=64, channel_max=16))
    tg = generator_config_from_dict(jconfig.to_dict(jg))
    gflat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(1), jg))
    assert jg.num_ws == JCFG.style_count
    avg = np.random.RandomState(6).randn(4, 512).astype(np.float32) * 0.1
    img = np.random.RandomState(7).randint(0, 256, (300, 200, 3), np.uint8)
    want_img, want_ws = jax.jit(lambda p, g, a: jinf.project_e4e(
        img, JCFG, p, jg, g, latent_avg=a))(jp, jck.flat_to_tree(gflat),
                                            jnp.asarray(avg))
    got_img, got_ws = tinf.project_e4e(img, TCFG, tp, tg,
                                       tck.flat_to_tree(gflat),
                                       latent_avg=torch.from_numpy(avg))
    _close(got_ws, want_ws)
    _close(got_img, want_img)
    batch = _x(8, n=1)
    want_img, want_ws = jax.jit(lambda p, g: jinf.project_e4e(
        batch, JCFG, p, jg, g))(jp, jck.flat_to_tree(gflat))
    got_img, got_ws = tinf.project_e4e(batch, TCFG, tp, tg,
                                       tck.flat_to_tree(gflat))
    _close(got_ws, want_ws)
    _close(got_img, want_img)
