"""The port's ReStyle protocol (``inversion/restyle.py::run_on_batch``,
``inference.project_restyle``) and its converter (``cli/convert_weights.py
restyle``, ``restyle.load_net``) against the JAX package's, on the seeded
weights of test_torch_restyle.py.

The iterative protocol feeds each decode back into the encoder, so rounding
differences of one iteration are the next one's input differences: JAX's
own test holds its jitted loop against its eager ops at 1e-4 of max for
iteration 0 and 2e-3 for iteration 1 (tests/test_restyle.py), and the port
is held to the same.  Conversions copy values: bit-equal.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu import inference as jinf
from gagan_tpu.inversion import restyle as jrs
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch import inference as tinf
from gagan_tpu_torch.cli import convert_weights as tcw
from gagan_tpu_torch.inversion import restyle as trs
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils.config import generator_config_from_dict

from .test_torch_restyle import (SIZE, _cfgs, _close, encoder_flat,
                                 restyle_checkpoint)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------------------------
# The iterative protocol on a narrow 256^2 G (14 W+ layers)

ENC = "ResNetProgressiveBackboneEncoder"


def _g_cfgs():
    jg = jsg.GeneratorConfig(
        img_resolution=SIZE, mapping=jsg.MappingConfig(num_layers=2),
        synthesis=jsg.SynthesisConfig(channel_base=1024, channel_max=32))
    return jg, generator_config_from_dict(jconfig.to_dict(jg))


@pytest.fixture(scope="module")
def nets():
    jg, tg = _g_cfgs()
    gflat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0), jg))
    eflat = encoder_flat(ENC, seed=3)
    avg = np.random.RandomState(2).randn(14, 512).astype(np.float32) * 0.5
    jcfg, tcfg = _cfgs(ENC)
    jnet = jrs.RestyleNet(enc_cfg=jcfg, enc_params=jck.flat_to_tree(eflat),
                          g_cfg=jg, g_params=jck.flat_to_tree(gflat),
                          latent_avg=jnp.asarray(avg))
    tnet = trs.RestyleNet(enc_cfg=tcfg, enc_params=tck.flat_to_tree(eflat),
                          g_cfg=tg, g_params=tck.flat_to_tree(gflat),
                          latent_avg=torch.from_numpy(avg))
    return jnet, tnet


def test_run_on_batch_matches_jax(nets):
    jnet, tnet = nets
    inputs = np.random.RandomState(4).uniform(-1, 1, (2, 3, 256, 256)).astype(
        np.float32)
    want_img, want_lat = jrs.run_on_batch(jnet, jnp.asarray(inputs), n_iters=2)
    got_img, got_lat = trs.run_on_batch(tnet, torch.from_numpy(inputs),
                                        n_iters=2)
    assert len(got_img) == len(got_lat) == 2
    for i, tol in enumerate((1e-4, 2e-3)):
        assert tuple(got_img[i].shape) == (2, 3, SIZE, SIZE)
        assert got_img[i].dtype == got_lat[i].dtype == torch.float32
        _close(got_lat[i], want_lat[i], tol)
        _close(got_img[i], want_img[i], tol)
    _close(trs.get_avg_image(tnet), jrs.get_avg_image(jnet), 1e-4)
    x6 = np.concatenate([inputs, inputs[:, ::-1]], axis=1)
    want_fwd = jnet.forward(jnp.asarray(x6))
    with torch.no_grad():
        got_fwd = tnet.forward(torch.from_numpy(x6))
    for g, w in zip(got_fwd, want_fwd):           # pooled images, codes
        _close(g, w, 1e-4)
    pooled, _ = trs.run_on_batch(tnet, torch.from_numpy(inputs), n_iters=1,
                                 resize_outputs=True)
    assert torch.equal(pooled[0], got_img[0])        # already 256^2


def test_project_restyle_matches_jax(nets):
    jnet, tnet = nets
    img = np.random.RandomState(7).randint(0, 256, (300, 200, 3), np.uint8)
    want_img, want_ws = jinf.project_restyle(img, jnet, n_iters=2)
    got_img, got_ws = tinf.project_restyle(img, tnet, n_iters=2)
    assert tuple(got_ws.shape) == (1, 14, 512)
    _close(got_ws, want_ws, 2e-3)
    _close(got_img, want_img, 2e-3)


# ----------------------------------------------------------------------------
# The converter


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "convert_weights_tool", os.path.join(REPO, "tools",
                                             "convert_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flat_avg", [True, False])
def test_restyle_from_torch_matches_the_tool(tool, flat_avg):
    ckpt = restyle_checkpoint("ResNetGradualStyleEncoder", 1, 16, flat_avg)
    want = tool.restyle_from_torch(ckpt)
    got = tcw.restyle_from_torch(ckpt)
    assert got[3] == want[3] == {"encoder_type": "ResNetGradualStyleEncoder",
                                 "output_size": 16, "input_nc": 6}
    for g, w in zip(got[:2], want[:2]):
        assert sorted(g) == sorted(w)
        assert not any("num_batches_tracked" in k for k in g)
        for k in w:
            assert g[k].dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[2].shape == (6, 512)
    np.testing.assert_array_equal(got[2], want[2])


def _same_nets(a, b):
    assert a.enc_cfg.encoder_type == b.enc_cfg.encoder_type
    assert a.enc_cfg.stylegan_size == b.enc_cfg.stylegan_size
    assert jconfig.to_dict(a.g_cfg) == jconfig.to_dict(b.g_cfg)
    for x, y in ((a.enc_params, b.enc_params), (a.g_params, b.g_params),
                 ({"l": a.latent_avg}, {"l": b.latent_avg})):
        fx, fy = tck.tree_to_flat(x), jck.tree_to_flat(y)
        assert sorted(fx) == sorted(fy)
        for k in fx:
            np.testing.assert_array_equal(fx[k], np.asarray(fy[k]), err_msg=k)


def test_restyle_npz_loads_in_both_packages(tool, tmp_path):
    """The port's npz in JAX's load_net and the JAX tool's npz in the
    port's, leaf for leaf; the port's loads fp32 with the fused level off,
    as JAX builds the rosinality decoder; and it runs."""
    ckpt = restyle_checkpoint("ProgressiveBackboneEncoder", 2, SIZE)
    src = str(tmp_path / "restyle.pt")
    torch.save(ckpt, src)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    tcw.convert_restyle(src, ours)
    tool.convert_restyle(src, theirs)
    tnet = trs.load_net(theirs, device="cpu")
    _same_nets(tnet, jrs.load_net(ours))
    assert tnet.g_cfg.synthesis.pallas_level is False
    assert tnet.g_cfg.synthesis.num_fp16_res == 0
    assert tnet.latent_avg.shape == (14, 512)
    img, ws = tinf.project_restyle(
        np.random.RandomState(0).randint(0, 256, (64, 64, 3), np.uint8),
        ours, n_iters=1, device="cpu")
    assert tuple(img.shape) == (1, 3, SIZE, SIZE)
    assert tuple(ws.shape) == (1, 14, 512)
    assert bool(torch.isfinite(img).all())
