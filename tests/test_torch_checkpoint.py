"""The weight bridge: JAX ``init_generator`` parameters load into the port's
``Generator`` by key, and snapshot ``.npz`` files cross between the two
packages in both directions with bit-equal values and equal configs."""

import jax
import numpy as np
import pytest
import torch

from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils import config as tconfig

torch.set_num_threads(2)


def _cfgs():
    def build(m):
        return m.GeneratorConfig(
            z_dim=32, w_dim=32, img_resolution=32,
            mapping=m.MappingConfig(num_layers=2),
            synthesis=m.SynthesisConfig(channel_base=512, channel_max=32,
                                        num_fp16_res=1, conv_clamp=256,
                                        packed_last_block=True,
                                        pallas_level=True))
    return build(jsg), build(tsg)


@pytest.fixture(scope="module")
def jax_flat():
    jcfg, _ = _cfgs()
    params = jax.jit(lambda k: jsg.init_generator(k, jcfg))(
        jax.random.PRNGKey(0))
    return jck.tree_to_flat(params)


def test_state_dict_keys_equal_jax_flat_keys(jax_flat):
    _, tcfg = _cfgs()
    G = tsg.Generator(tcfg, device="cpu")
    sd = G.state_dict()
    assert set(sd) == set(jax_flat)
    for k, v in jax_flat.items():
        assert tuple(sd[k].shape) == v.shape, k
    assert "synthesis.b32.conv1.noise_const" in sd and "mapping.w_avg" in sd


def test_load_flat_is_bit_equal(jax_flat):
    _, tcfg = _cfgs()
    G = tsg.Generator(tcfg, device="cpu").load_flat(jax_flat)
    for k, t in G.state_dict().items():
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), jax_flat[k]), k
    back = tck.tree_to_flat(G.params())
    assert set(back) == set(jax_flat)
    for k, v in back.items():
        assert np.array_equal(v, jax_flat[k]), k


def test_load_flat_rejects_other_keys(jax_flat):
    _, tcfg = _cfgs()
    G = tsg.Generator(tcfg, device="cpu")
    bad = dict(jax_flat)
    bad.pop("mapping.w_avg")
    bad["mapping.w_avg_typo"] = np.zeros(32, np.float32)
    with pytest.raises(KeyError, match="w_avg"):
        G.load_flat(bad)


def test_snapshot_jax_to_torch(jax_flat, tmp_path):
    jcfg, tcfg = _cfgs()
    path = str(tmp_path / "jax.npz")
    jck.save_snapshot(path, g_ema=jck.flat_to_tree(jax_flat),
                      config={"g_cfg": jconfig.to_dict(jcfg)},
                      extra={"step": np.int64(7)})
    trees, config = tck.load_snapshot(path)
    got = tck.tree_to_flat(trees["G_ema"])
    assert set(got) == set(jax_flat)
    for k, v in got.items():
        assert np.array_equal(v, jax_flat[k]), k
    assert int(trees["extra"]["step"]) == 7
    cfg = tconfig.generator_config_from_dict(config["g_cfg"])
    assert cfg == tcfg
    assert cfg.synthesis.pallas_level


def test_snapshot_torch_to_jax(tmp_path):
    jcfg, tcfg = _cfgs()
    G = tsg.Generator(tcfg, device="cpu", seed=3)
    path = str(tmp_path / "torch.npz")
    tck.save_snapshot(path, g_ema=G.params(),
                      config={"g_cfg": tconfig.to_dict(tcfg)})
    trees, config = jck.load_snapshot(path)
    got = jck.tree_to_flat(trees["G_ema"])
    want = G.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.array_equal(v, want[k].numpy()), k
    assert jconfig.generator_config_from_dict(config["g_cfg"]) == jcfg


def test_config_dicts_are_identical():
    jcfg, tcfg = _cfgs()
    assert jconfig.to_dict(jcfg) == tconfig.to_dict(tcfg)
    assert tconfig.to_dict(tconfig.generator_config_from_dict(
        jconfig.to_dict(jcfg))) == jconfig.to_dict(jcfg)
