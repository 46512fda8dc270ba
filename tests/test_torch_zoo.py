"""The model zoo (``models/{proggan,sngan,biggan,zoo}.py``) against the JAX
package on the CPU: the same flat weights (an npz both packages load),
the same latents, forward and ``gen_shifted`` (in w and in z for
StyleGAN2), within the suite's 2e-4 (relative to max|img| for ProgGAN,
whose WScale output is unbounded; the tanh models are in [-1, 1]).

Random weights are made non-trivial where init leaves them at identity:
batch-norm statistics, BigGAN's attention gain (0 at init) and ProgGAN's
WScale biases are set from a seeded numpy stream; SN-GAN's weights are
rescaled to 1/sqrt(fan-in) (see ``_perturbed``).  ProgGAN runs at its
fixed 1024^2 and 512 channels, at batch 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.models import biggan as jbg
from gagan_tpu.models import sngan as jsn
from gagan_tpu.models import zoo as jzoo
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.models import biggan as tbg
from gagan_tpu_torch.models import proggan as tpg
from gagan_tpu_torch.models import sngan as tsn
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.models import zoo as tzoo
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils.config import to_dict

torch.set_num_threads(4)

TOL = 2e-4


def _perturbed(flat, seed, rescale=False):
    """Stored statistics, attention gain and biases away from identity;
    with ``rescale``, weights of std 1/sqrt(fan-in) (SN-GAN's init std of
    0.05 grows the activations ~5x a conv at its 1024 channels, so its tanh
    saturates and the few unsaturated outputs read rounding of values near
    1e6)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in flat.items():
        v = np.array(v)
        if rescale and k.endswith("weight") and v.ndim in (2, 4):
            v = (v / v.std() / np.sqrt(np.prod(v.shape[1:]))).astype(
                np.float32)
        if k.endswith(("running_mean", "stored_mean")) or k.endswith(".b") \
                or (k.endswith(".bias") and v.ndim == 1):
            v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith(("running_var", "stored_var")):
            v = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k.endswith("gamma"):
            v = np.float32(0.7)
        out[k] = v
    return out


def _npz(tmp_path, name, flat):
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, **flat)
    return path


def _close(got, want, rel=False):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    atol = TOL * (np.abs(want).max() if rel else 1.0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=atol)


@pytest.mark.parametrize("arch", ["sn_resnet32", "sn_resnet64"])
def test_sngan_matches_jax(arch):
    cfg_t, cfg_j = tsn.SNGANConfig(arch=arch), jsn.SNGANConfig(arch=arch)
    flat = _perturbed(tck.tree_to_flat(tsn.init_sngan(
        torch.Generator().manual_seed(1), cfg_t)), 2, rescale=True)
    jflat = jck.tree_to_flat(jsn.init_sngan(jax.random.PRNGKey(0), cfg_j))
    assert {k: v.shape for k, v in flat.items()} == {
        k: v.shape for k, v in jflat.items()}
    z = np.random.RandomState(3).randn(2, 128).astype(np.float32)
    got = tsn.sngan_apply(cfg_t, tck.flat_to_tree(flat), torch.from_numpy(z))
    assert tuple(got.shape) == (2, 3, cfg_t.resolution, cfg_t.resolution)
    _close(got, jsn.sngan_apply(cfg_j, jck.flat_to_tree(flat), jnp.asarray(z)))


def test_biggan_matches_jax():
    """ch 16 at 32^2 with attention at 16 (at the default 64 a 32^2 G has
    none), hierarchical z over 4 slots."""
    kw = dict(ch=16, resolution=32, attention=16, n_classes=10)
    cfg_t, cfg_j = tbg.BigGANConfig(**kw), jbg.BigGANConfig(**kw)
    assert cfg_t.arch == cfg_j.arch and cfg_t.arch["attention"][16]
    flat = _perturbed(tck.tree_to_flat(tbg.init_biggan(
        torch.Generator().manual_seed(4), cfg_t)), 5)
    jflat = jck.tree_to_flat(jbg.init_biggan(jax.random.PRNGKey(0), cfg_j))
    assert {k: v.shape for k, v in flat.items()} == {
        k: v.shape for k, v in jflat.items()}
    z = np.random.RandomState(6).randn(3, 120).astype(np.float32)
    c = np.array([1, 7, 3])
    got = tbg.biggan_apply(cfg_t, tck.flat_to_tree(flat), torch.from_numpy(z),
                           torch.from_numpy(c))
    _close(got, jbg.biggan_apply(cfg_j, jck.flat_to_tree(flat),
                                 jnp.asarray(z), jnp.asarray(c)))


def _stylegan2_snapshot(tmp_path):
    cfg = tsg.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=32,
        mapping=tsg.MappingConfig(num_layers=2),
        synthesis=tsg.SynthesisConfig(channel_base=512, channel_max=32,
                                      packed_last_block=True))
    params = tsg.init_generator(cfg, torch.Generator().manual_seed(7), "cpu")
    params["mapping"]["w_avg"] += 0.3
    path = str(tmp_path / "snap.npz")
    tck.save_snapshot(path, g_ema=params, config={"g_cfg": to_dict(cfg)})
    return path


@pytest.mark.parametrize("shift_in_w", [True, False])
def test_stylegan2_handle_matches_jax(shift_in_w, tmp_path):
    snap = _stylegan2_snapshot(tmp_path)
    kw = dict(shift_in_w=shift_in_w, truncation=0.7)
    th = tzoo.make_generator("stylegan2", snapshot_path=snap, device="cpu",
                             **kw)
    jh = jzoo.make_generator("stylegan2", snapshot_path=snap, **kw)
    assert (th.dim_z, th.dim_shift) == (jh.dim_z, jh.dim_shift)
    rng = np.random.RandomState(8)
    z = rng.randn(2, 32).astype(np.float32)
    shift = rng.randn(2, th.dim_shift).astype(np.float32) * 0.5
    _close(th.forward(torch.from_numpy(z)), jh.forward(jnp.asarray(z)))
    _close(th.gen_shifted(torch.from_numpy(z), torch.from_numpy(shift)),
           jh.gen_shifted(jnp.asarray(z), jnp.asarray(shift)))
    # gen_shifted is differentiable with respect to the shift.
    s = torch.from_numpy(shift).requires_grad_(True)
    th.gen_shifted(torch.from_numpy(z), s).square().sum().backward()
    assert s.grad is not None and bool(torch.isfinite(s.grad).all())


def test_biggan_handle_mixes_classes_as_jax(tmp_path):
    kw = dict(ch=16, resolution=32, attention=16, n_classes=10)
    flat = _perturbed(tck.tree_to_flat(tbg.init_biggan(
        torch.Generator().manual_seed(9), tbg.BigGANConfig(**kw))), 10)
    path = _npz(tmp_path, "biggan", flat)
    th = tzoo.make_generator("biggan", weights_path=path,
                             target_classes=(2, 5, 9), device="cpu", **kw)
    jh = jzoo.make_generator("biggan", weights_path=path,
                             target_classes=(2, 5, 9), **kw)
    z = np.random.RandomState(11).randn(4, 120).astype(np.float32)
    shift = np.random.RandomState(12).randn(4, 120).astype(np.float32) * 0.1
    # Two calls each: the second draws its classes from RandomState(1).
    _close(th.forward(torch.from_numpy(z)), jh.forward(jnp.asarray(z)))
    _close(th.gen_shifted(torch.from_numpy(z), torch.from_numpy(shift)),
           jh.gen_shifted(jnp.asarray(z), jnp.asarray(shift)))
    _close(th.forward(torch.from_numpy(z), class_ids=[1, 1, 0, 3]),
           jh.forward(jnp.asarray(z), class_ids=[1, 1, 0, 3]))


@pytest.mark.parametrize("name", ["sn_mnist", "sn_anime"])
def test_sngan_handles_match_jax(name, tmp_path):
    arch = {"sn_mnist": "sn_resnet32", "sn_anime": "sn_resnet128"}[name]
    flat = _perturbed(tck.tree_to_flat(tsn.init_sngan(
        torch.Generator().manual_seed(13), tsn.SNGANConfig(arch=arch))), 14,
        rescale=True)
    path = _npz(tmp_path, name, flat)
    th = tzoo.make_generator(name, weights_path=path, device="cpu")
    jh = jzoo.make_generator(name, weights_path=path)
    z = np.random.RandomState(15).randn(1, 128).astype(np.float32)
    shift = np.random.RandomState(16).randn(1, 128).astype(np.float32) * 0.1
    _close(th.gen_shifted(torch.from_numpy(z), torch.from_numpy(shift)),
           jh.gen_shifted(jnp.asarray(z), jnp.asarray(shift)))


def test_proggan_handle_matches_jax(tmp_path):
    flat = _perturbed(tck.tree_to_flat(tpg.init_proggan(
        torch.Generator().manual_seed(17))), 18)
    path = _npz(tmp_path, "proggan", flat)
    th = tzoo.make_generator("proggan", weights_path=path, device="cpu")
    jh = jzoo.make_generator("proggan", weights_path=path)
    assert (th.dim_z, th.dim_shift) == (jh.dim_z, jh.dim_shift) == (512, 512)
    z = np.random.RandomState(19).randn(1, 512).astype(np.float32)
    shift = np.random.RandomState(20).randn(1, 512).astype(np.float32) * 0.1
    got = th.gen_shifted(torch.from_numpy(z), torch.from_numpy(shift))
    assert tuple(got.shape) == (1, 3, 1024, 1024)
    _close(got, jh.gen_shifted(jnp.asarray(z), jnp.asarray(shift)), rel=True)


def test_makers_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.make_generator("sn_mnist")
