"""The port's ``Inferencer`` with ``original`` checkpoints and its
``adaptation_from_torch`` (gagan_tpu_torch/inference.py,
cli/convert_weights.py) against the JAX package's.

An ``original`` adaptation holds a second generator's ``synthesis``: the
adapted renders are that generator's, exactly (its keys replace the
source's in a copy).  The render runs on a 256^2 G of 128 channels with
``pallas_level=True`` on both sides, so b128.conv1 goes through JAX's
interpreted Pallas kernel and the port's fused op (its plain version on
the CPU): 2e-4 of max|JAX|, the suite's forward tolerance.  Conversion
copies values: equal.
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu import inference as jinf
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch import inference as tinf
from gagan_tpu_torch.cli import convert_weights as tcw
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.ops import fused_modconv as fmc
from gagan_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, tol=2e-4):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A snapshot of G0 and an ``original`` adaptation holding G1's
    synthesis, written by the JAX package."""
    g = jsg.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=256,
        mapping=jsg.MappingConfig(num_layers=1),
        synthesis=jsg.SynthesisConfig(channel_base=16384, channel_max=128,
                                      conv_clamp=256, packed_last_block=True,
                                      pallas_level=True))
    p0 = jsg.init_generator(jax.random.PRNGKey(0), g)
    p1 = jsg.init_generator(jax.random.PRNGKey(1), g)
    d = tmp_path_factory.mktemp("inference")
    snap, adapt = str(d / "snap.npz"), str(d / "original.npz")
    jck.save_snapshot(snap, g_ema=p0, config={"g_cfg": jconfig.to_dict(g)})
    jck.save_adaptation(adapt, model_type="original", parametrization="",
                        offsets={"synthesis": p1["synthesis"],
                                 "not_in_g": {"x": np.ones(3, np.float32)}},
                        sg2_config={"img_size": 256})
    return g, p1, snap, adapt


def test_original_inferencer_matches_jax(files, monkeypatch):
    g, p1, snap, adapt = files
    calls = []
    ref = fmc.fused_modconv3x3_ref
    monkeypatch.setattr(fmc, "fused_modconv3x3_ref",
                        lambda x, *a: calls.append(tuple(x.shape)) or ref(x, *a))
    jinfer = jinf.Inferencer(adapt, snap)
    tinfer = tinf.Inferencer(adapt, snap, device="cpu")
    assert tinfer.model_type == "original" and tinfer.hooks is None
    assert "not_in_g" not in tinfer.g_params_adapted
    ws = np.random.RandomState(2).randn(1, g.num_ws, 32).astype(np.float32)
    want_src, want_trg = jinfer.from_wplus(ws)
    got_src, got_trg = tinfer.from_wplus(ws)
    assert calls == [(1, 128, 128, 128)] * 2        # b128.conv1, fused
    _close(got_src, want_src)
    _close(got_trg, want_trg)
    # The target is G1's render, on the same code path.
    plain = jsg.synthesis_apply(g.synthesis, p1["synthesis"], jnp.asarray(ws),
                                noise_mode="const")
    _close(got_trg, plain)
    assert np.abs(np.asarray(want_trg) - np.asarray(want_src)).max() > 0.1
    # The z path: the source mapping, then both renders.
    z = np.random.RandomState(3).randn(1, 32).astype(np.float32)
    want = jinfer(jnp.asarray(z), truncation=0.7)
    got = tinfer(z, truncation=0.7)
    for a, b in zip(got, want):
        _close(a, b)


def test_original_inferencer_renders_the_second_g_bit_for_bit(files):
    """The port's own merge: G1's leaves render as a G built on them."""
    g, p1, snap, adapt = files
    tinfer = tinf.Inferencer(adapt, snap, device="cpu")
    ws = torch.from_numpy(np.random.RandomState(4).randn(
        2, g.num_ws, 32).astype(np.float32))
    _, trg = tinfer.from_wplus(ws)
    g1 = tck.flat_to_tree(jck.tree_to_flat(p1["synthesis"]))
    with torch.no_grad():
        want = tsg.synthesis_apply(tinfer.g_cfg.synthesis, g1, ws,
                                   noise_mode="const")
    assert torch.equal(trg, want)
    src_leaves = tck.tree_to_flat_tensors(tinfer.g_params)
    assert all(torch.equal(v, tck.tree_to_flat_tensors(
        tck.load_snapshot(snap)[0]["G_ema"])[k])
        for k, v in src_leaves.items())      # the source G is untouched


# ----------------------------------------------------------------------------
# adaptation_from_torch


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "convert_weights_tool", os.path.join(REPO, "tools",
                                             "convert_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_checkpoint(patch_key, seed=0):
    """The reference's portable checkpoint of a 32^2 G (7 convs): one head
    per conv, its trained leaf under the table's name and of the size of
    the offsets leaf it fills (flattened), plus an unknown leaf, a head past
    the generator's convs and a non-head key (all skipped)."""
    obj = {"model_type": "parametrization", "patch_key": patch_key,
           "state_dict": {}, "sg2_params": {"img_size": 32}}
    (src, dst), = tcw._ADAPT_HEAD_LEAF[patch_key].items()
    _, zeros = tcw.adaptation_from_torch(obj)
    rng = np.random.RandomState(seed)
    sd = {}
    for i, name in enumerate([n for n in zeros if not n.endswith("torgb")]
                             + ["extra"]):
        size = zeros[name][dst].size if name in zeros else 8
        sd[f"heads.conv_{i}.{src}"] = torch.from_numpy(
            rng.randn(1, size).astype(np.float32))
        sd[f"heads.conv_{i}.other"] = torch.zeros(2)
    sd["mapper.weight"] = torch.zeros(3)
    return dict(obj, state_dict=sd)


@pytest.mark.parametrize("patch_key", sorted(tcw._ADAPT_HEAD_LEAF))
def test_adaptation_from_torch_matches_the_tool(tool, patch_key):
    assert tcw._ADAPT_HEAD_LEAF == tool._ADAPT_HEAD_LEAF
    obj = {"patch_key": patch_key, "state_dict": {}}
    try:
        tool.adaptation_from_torch(obj)
    except ValueError as e:                  # a key the grammar refuses
        assert "Unknown weight parametrization" in str(e)
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tcw.adaptation_from_torch(obj)
        return
    obj = _reference_checkpoint(patch_key)
    want = tool.adaptation_from_torch(obj)
    got = tcw.adaptation_from_torch(obj)
    assert got[0] == want[0]
    assert got[0]["heads_consumed"] == 7 and got[0]["heads_expected"] == 8
    gflat, wflat = tck.tree_to_flat(got[1]), jck.tree_to_flat(want[1])
    assert sorted(gflat) == sorted(wflat)
    for k, v in wflat.items():
        assert gflat[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(gflat[k], np.asarray(v), err_msg=k)
    assert any(np.abs(v).max() > 0 for v in gflat.values())


def test_adaptation_from_torch_refuses_unknown_keys(tool):
    obj = _reference_checkpoint("s_delta")
    for o in (dict(obj, patch_key="bogus"), dict(obj, patch_key=None)):
        with pytest.raises(ValueError, match="unsupported patch_key"):
            tool.adaptation_from_torch(o)
        with pytest.raises(ValueError, match="unsupported patch_key"):
            tcw.adaptation_from_torch(o)
