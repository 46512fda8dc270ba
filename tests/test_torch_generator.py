"""The port's generator slice (gagan_tpu_torch.models.stylegan2) against the
JAX package's ``generator_apply`` on the same weights, both with
``pallas_level=True``: JAX runs b128.conv1 through its interpreted Pallas
kernel, the port through the fused op's plain version (the CPU path).

256x256 at channel_max 128, mapping 2 layers, packed last block, const noise,
batch 2.  Noise strengths, biases and w_avg are set non-zero (they are zero
at init) so the noise, bias and truncation paths do real work.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.ops import pallas_modconv as pmc
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.ops import fused_modconv as fmc
from gagan_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)


def _cfgs(num_fp16_res):
    def build(m):
        return m.GeneratorConfig(
            z_dim=64, w_dim=64, img_resolution=256,
            mapping=m.MappingConfig(num_layers=2),
            synthesis=m.SynthesisConfig(
                channel_base=16384, channel_max=128, conv_clamp=256,
                packed_last_block=True, num_fp16_res=num_fp16_res,
                pallas_level=True))
    return build(jsg), build(tsg)


def _weights(tcfg, seed=0):
    flat = tck.tree_to_flat(tsg.init_generator(
        tcfg, torch.Generator().manual_seed(seed), "cpu"))
    rng = np.random.RandomState(seed)
    for k, v in flat.items():
        if k.endswith("noise_strength"):
            flat[k] = np.float32(rng.uniform(0.05, 0.3))
        elif k.startswith("synthesis") and k.endswith(".bias") \
                and ".affine." not in k:
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("w_avg"):
            flat[k] = (rng.randn(*v.shape) * 0.5).astype(np.float32)
    return flat


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("num_fp16_res,psi", [(0, 1.0), (2, 0.7)])
def test_generator_matches_jax(num_fp16_res, psi, monkeypatch):
    jcfg, tcfg = _cfgs(num_fp16_res)
    flat = _weights(tcfg)
    z = np.random.RandomState(1).randn(2, 64).astype(np.float32)

    # JAX routes b128.conv1 (2 x 128 x 128 x 128) to the Pallas kernel.
    assert pmc.supported_shape((2, 128, 128, 128), (128, 128, 3, 3))
    fwd = jax.jit(lambda p, z: jsg.generator_apply(
        jcfg, p, z, truncation_psi=psi, noise_mode="const"))
    want = np.asarray(fwd(jck.flat_to_tree(flat), jnp.asarray(z)))

    calls = []
    ref = fmc.fused_modconv3x3_ref
    monkeypatch.setattr(fmc, "fused_modconv3x3_ref",
                        lambda x, *a: calls.append(tuple(x.shape)) or ref(x, *a))
    G = tsg.Generator(tcfg, device="cpu").load_flat(flat)
    with torch.no_grad():
        got = G(torch.from_numpy(z), truncation_psi=psi,
                noise_mode="const").numpy()
    assert calls == [(2, 128, 128, 128)]      # b128.conv1, as in JAX

    assert got.shape == want.shape == (2, 3, 256, 256)
    assert np.isfinite(got).all()
    m = float(np.abs(want).max())
    err = np.abs(got - want)
    if num_fp16_res == 0:
        # float32 throughout: summation order only.
        assert err.max() <= 2e-4 * m
    else:
        # bf16 at 128 and 256: the packages round the same tensors to bf16
        # but sum convolutions in other orders, so single values may land one
        # bf16 rounding apart.  The image is the fp32 sum of two bf16 torgb
        # outputs (b128's, upsampled, and b256's), so it stays within two
        # bf16 ulps of its peak, and on average far below.
        assert err.max() <= 2 * _bf16_ulp(m)
        assert err.mean() <= 2.0 ** -10 * m


@pytest.mark.parametrize("cutoff", [None, 3])
def test_mapping_truncation_matches_jax(cutoff):
    jcfg, tcfg = _cfgs(0)
    flat = _weights(tcfg, seed=2)
    jtree, ttree = jck.flat_to_tree(flat), tck.flat_to_tree(flat)
    assert np.abs(flat["mapping.w_avg"]).max() > 0
    z = np.random.RandomState(3).randn(4, 64).astype(np.float32)
    want = jsg.mapping_apply(jcfg.mapping, jtree["mapping"], jnp.asarray(z),
                             truncation_psi=0.7, truncation_cutoff=cutoff)
    got = tsg.mapping_apply(tcfg.mapping, ttree["mapping"], torch.from_numpy(z),
                            truncation_psi=0.7, truncation_cutoff=cutoff)
    assert tuple(got.shape) == (4, tcfg.num_ws, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_unpacked_and_packed_tail_agree():
    """The packed last block is an exact reformulation of the plain one."""
    _, tcfg = _cfgs(0)
    flat = _weights(tcfg, seed=4)
    params = tck.flat_to_tree(flat)
    ws = torch.from_numpy(
        np.random.RandomState(5).randn(1, tcfg.num_ws, 64).astype(np.float32))
    plain = dataclasses.replace(tcfg.synthesis, packed_last_block=False)
    with torch.no_grad():
        a = tsg.synthesis_apply(tcfg.synthesis, params["synthesis"], ws)
        b = tsg.synthesis_apply(plain, params["synthesis"], ws)
    m = float(b.abs().max())
    assert float((a - b).abs().max()) <= 2e-4 * m


def test_random_noise_follows_the_torch_generator():
    """noise_mode='random' draws from the caller's torch.Generator: the same
    seed gives the same image, another seed or const noise another one."""
    _, tcfg = _cfgs(0)
    cfg = dataclasses.replace(
        tcfg, img_resolution=32,
        synthesis=dataclasses.replace(tcfg.synthesis, img_resolution=32))
    params = tck.flat_to_tree(_weights(cfg, seed=6))
    z = torch.from_numpy(np.random.RandomState(7).randn(2, 64).astype(np.float32))

    def run(**kw):
        with torch.no_grad():
            return tsg.generator_apply(cfg, params, z, **kw)

    a = run(noise_mode="random", generator=torch.Generator().manual_seed(1))
    b = run(noise_mode="random", generator=torch.Generator().manual_seed(1))
    c = run(noise_mode="random", generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, run())
    with pytest.raises(ValueError, match="torch.Generator"):
        run(noise_mode="random")


def test_unported_packed_tail_settings_raise():
    """The packed tail's other settings, once refused, now run: two blocks
    packed, and the unfused torgb, each an exact reformulation of the
    unpacked forward (tests/test_torch_packed_tail.py holds them against
    JAX)."""
    _, tcfg = _cfgs(0)
    params = tck.flat_to_tree(_weights(tcfg, seed=8))
    ws = torch.from_numpy(
        np.random.RandomState(9).randn(1, tcfg.num_ws, 64).astype(np.float32))
    plain = dataclasses.replace(tcfg.synthesis, packed_last_block=False)
    with torch.no_grad():
        want = tsg.synthesis_apply(plain, params["synthesis"], ws)
        for change in ({"packed_tail_blocks": 2}, {"packed_fused_torgb": False}):
            cfg = dataclasses.replace(tcfg.synthesis, **change)
            got = tsg.synthesis_apply(cfg, params["synthesis"], ws)
            assert float((got - want).abs().max()) <= 2e-4 * float(
                want.abs().max())
