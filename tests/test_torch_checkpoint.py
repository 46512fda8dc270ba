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


def _d_cfgs():
    def build(m):
        return m.DiscriminatorConfig(img_resolution=32, channel_base=512,
                                     channel_max=32, num_fp16_res=1,
                                     conv_clamp=256, packed_first_block=True)
    return build(jsg), build(tsg)


def test_training_snapshot_jax_to_torch(jax_flat, tmp_path):
    """A JAX snapshot with G, D and G_ema loads into the port's modules."""
    jg, tg = _cfgs()
    jd, td = _d_cfgs()
    d_flat = jck.tree_to_flat(jsg.init_discriminator(jax.random.PRNGKey(1),
                                                     jd))
    ema = {k: v + np.float32(1) for k, v in jax_flat.items()}
    path = str(tmp_path / "train.npz")
    jck.save_snapshot(path, g_params=jck.flat_to_tree(jax_flat),
                      d_params=jck.flat_to_tree(d_flat),
                      g_ema=jck.flat_to_tree(ema),
                      config={"g_cfg": jconfig.to_dict(jg),
                              "d_cfg": jconfig.to_dict(jd)})
    trees, config = tck.load_snapshot(path)
    assert tconfig.discriminator_config_from_dict(config["d_cfg"]) == td
    G = tsg.Generator(tg, "cpu").load_flat(tck.tree_to_flat(trees["G"]))
    D = tsg.Discriminator(td, "cpu").load_flat(tck.tree_to_flat(trees["D"]))
    E = tsg.Generator(tg, "cpu").load_flat(tck.tree_to_flat(trees["G_ema"]))
    for module, want in ((G, jax_flat), (D, d_flat), (E, ema)):
        got = module.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert np.array_equal(got[k].numpy(), v), k


def test_training_snapshot_torch_to_jax(tmp_path):
    jg, tg = _cfgs()
    jd, td = _d_cfgs()
    G = tsg.Generator(tg, "cpu", seed=4)
    D = tsg.Discriminator(td, "cpu", seed=5)
    path = str(tmp_path / "train.npz")
    tck.save_snapshot(path, g_params=G.params(), d_params=D.params(),
                      g_ema=G.params(),
                      config={"g_cfg": tconfig.to_dict(tg),
                              "d_cfg": tconfig.to_dict(td)})
    trees, config = jck.load_snapshot(path)
    assert jconfig.discriminator_config_from_dict(config["d_cfg"]) == jd
    want_d = jck.tree_to_flat(jsg.init_discriminator(jax.random.PRNGKey(0),
                                                     jd))
    for name, module in (("G", G), ("D", D), ("G_ema", G)):
        got = jck.tree_to_flat(trees[name])
        sd = module.state_dict()
        assert set(got) == set(sd)
        for k, v in got.items():
            assert np.array_equal(v, sd[k].numpy()), k
    assert set(jck.tree_to_flat(trees["D"])) == set(want_d)
    for k, v in want_d.items():
        assert jck.tree_to_flat(trees["D"])[k].shape == v.shape, k
