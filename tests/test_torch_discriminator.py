"""The port's discriminator (gagan_tpu_torch.models.stylegan2) against the
JAX package's ``discriminator_apply`` on the same weights: JAX's init crosses
as numpy.  32x32, channel_base 1024 / channel_max 64, batch 4, mbstd groups
of 2; biases set non-zero (they are zero at init).

Tolerances: forward 2e-4 of max|logit| and gradients 1e-3 of each
gradient's max|.| in float32 (the JAX suite's, tests/test_ops_parity.py);
with bf16 blocks both packages round the same tensors to bf16 but sum
convolutions in other orders, so a value may land one bf16 rounding
(2^-8 relative) apart and carry it downstream: 2^-5 of max|.|.  The bias
gradients of bf16 layers are sums of N*H*W bf16 terms that mostly cancel:
both packages land about 13% (relative L2) from the float32 gradient, in
different directions, so those leaves are held to 0.25 relative L2 of the
float32 gradient (JAX's, with ``force_fp32``) instead of to JAX's bf16 one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.ops import packed as jpk
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.ops import packed as tpk
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils import config as tconfig

torch.set_num_threads(2)

VARIANTS = {
    "resnet": dict(),
    "skip": dict(architecture="skip"),
    "packed1": dict(packed_first_block=True),
    "packed2": dict(packed_first_block=True, packed_head_blocks=2),
    "bf16": dict(num_fp16_res=2, conv_clamp=256),
    "packed_bf16": dict(packed_first_block=True, packed_head_blocks=2,
                        num_fp16_res=2, conv_clamp=256),
    "cond": dict(c_dim=5, mbstd_num_channels=2),
}


def _cfgs(**kw):
    def build(m):
        return m.DiscriminatorConfig(
            img_resolution=32, channel_base=1024, channel_max=64,
            mbstd_group_size=2, mapping=m.MappingConfig(num_layers=2), **kw)
    return build(jsg), build(tsg)


def _flat(jcfg, seed=0):
    flat = jck.tree_to_flat(jsg.init_discriminator(jax.random.PRNGKey(seed),
                                                   jcfg))
    rng = np.random.RandomState(seed)
    for k, v in flat.items():
        if k.endswith(".bias"):
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return flat


def _inputs(jcfg, seed=1):
    rng = np.random.RandomState(seed)
    img = rng.randn(4, 3, 32, 32).astype(np.float32)
    c = (rng.randn(4, jcfg.c_dim).astype(np.float32) if jcfg.c_dim else None)
    return img, c


def _tol(kw):
    return 2.0 ** -5 if kw.get("num_fp16_res") else None


def close(got, want, rel):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_discriminator_matches_jax(name):
    kw = VARIANTS[name]
    jcfg, tcfg = _cfgs(**kw)
    flat = _flat(jcfg)
    img, c = _inputs(jcfg)
    D = tsg.Discriminator(tcfg, device="cpu").load_flat(flat)
    assert set(D.state_dict()) == set(flat)
    want = jsg.discriminator_apply(jcfg, jck.flat_to_tree(flat),
                                   jnp.asarray(img),
                                   None if c is None else jnp.asarray(c))
    got = D(torch.from_numpy(img), None if c is None else torch.from_numpy(c))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 1)
    close(got, want, _tol(kw) or 2e-4)


@pytest.mark.parametrize("name", ["resnet", "skip", "packed2", "cond",
                                  "packed_bf16"])
def test_discriminator_gradients_match_jax(name):
    """d(sum w*logits) with respect to the image and every parameter."""
    kw = VARIANTS[name]
    jcfg, tcfg = _cfgs(**kw)
    flat = _flat(jcfg, seed=2)
    img, c = _inputs(jcfg, seed=3)
    wts = np.random.RandomState(4).randn(4, 1).astype(np.float32)
    jc = None if c is None else jnp.asarray(c)

    def jloss(p, x):
        return jnp.sum(jsg.discriminator_apply(jcfg, p, x, jc) * wts)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jck.flat_to_tree(flat),
                                                 jnp.asarray(img))
    jflat = jck.tree_to_flat(jg_p)
    bf16_biases = set()
    if kw.get("num_fp16_res"):
        bf16_biases = {k for k in jflat if k.endswith(".bias")
                       and int(k.split(".")[0][1:]) >= jcfg.bf16_resolution}
        j32 = jck.tree_to_flat(jax.grad(lambda p: jnp.sum(
            jsg.discriminator_apply(jcfg, p, jnp.asarray(img), jc,
                                    force_fp32=True) * wts))(
            jck.flat_to_tree(flat)))
    tparams = tck.flat_to_tree(flat)
    leaves = {k: v.requires_grad_() for k, v in tck.tree_to_flat_tensors(
        tparams).items()}
    x = torch.from_numpy(img).requires_grad_()
    out = tsg.discriminator_apply(tcfg, tparams, x,
                                  None if c is None else torch.from_numpy(c))
    (out * torch.from_numpy(wts)).sum().backward()
    rel = _tol(kw) or 1e-3
    close(x.grad, jg_x, rel)
    assert set(jflat) == set(leaves)
    for k, t in leaves.items():
        if k in bf16_biases:
            err = np.linalg.norm(t.grad.numpy() - j32[k])
            assert err <= 0.25 * np.linalg.norm(j32[k]), k
        else:
            close(t.grad, jflat[k], rel)


@pytest.mark.parametrize("name", ["resnet", "packed2"])
def test_r1_double_gradient_matches_jax(name):
    """d/dparams of sum |d sum(logits) / d img|^2: the R1 penalty's
    gradient, a double backward through every op of the discriminator.
    2e-3 of max|.|: each second-order term sums products of first-order
    sums, so summation order counts twice (worst seen 1.3e-3)."""
    kw = VARIANTS[name]
    jcfg, tcfg = _cfgs(**kw)
    flat = _flat(jcfg, seed=5)
    img, _ = _inputs(jcfg, seed=6)

    def jr1(p):
        g = jax.grad(lambda x: jnp.sum(jsg.discriminator_apply(jcfg, p, x)))(
            jnp.asarray(img))
        return jnp.sum(jnp.square(g))

    jval, jg = jax.value_and_grad(jr1)(jck.flat_to_tree(flat))
    tparams = tck.flat_to_tree(flat)
    leaves = {k: v.requires_grad_() for k, v in tck.tree_to_flat_tensors(
        tparams).items()}
    x = torch.from_numpy(img).requires_grad_()
    (gx,) = torch.autograd.grad(tsg.discriminator_apply(tcfg, tparams, x).sum(),
                                x, create_graph=True)
    r1 = gx.square().sum()
    r1.backward()
    np.testing.assert_allclose(float(r1), float(jval), rtol=1e-4)
    jflat = jck.tree_to_flat(jg)
    for k, t in leaves.items():
        if t.grad is None:          # e.g. the output bias: no image gradient
            assert not np.any(jflat[k]), k
        else:
            close(t.grad, jflat[k], 2e-3)


def test_packed_head_builders_match_jax():
    rng = np.random.RandomState(9)
    w = rng.randn(3, 5, 3, 3).astype(np.float32)
    w1 = rng.randn(3, 5, 1, 1).astype(np.float32)
    f = np.asarray([1, 3, 3, 1], np.float32) / 8
    tf, jf = torch.from_numpy(f), jnp.asarray(f)
    close(tpk.build_packed_downconv(torch.from_numpy(w), tf),
          jpk.build_packed_downconv(jnp.asarray(w), jf), 1e-6)
    close(tpk.build_packed_down1x1(torch.from_numpy(w1), tf),
          jpk.build_packed_down1x1(jnp.asarray(w1), jf), 1e-6)
    close(tpk.build_packed_conv1x1(torch.from_numpy(w1)),
          jpk.build_packed_conv1x1(jnp.asarray(w1)), 0)


def test_minibatch_std_matches_jax():
    x = np.random.RandomState(10).randn(6, 8, 4, 4).astype(np.float32)
    for group, chans in ((2, 1), (3, 2), (None, 1)):
        close(tsg.minibatch_std(torch.from_numpy(x), group, chans),
              jsg.minibatch_std(jnp.asarray(x), group, chans), 1e-6)


def test_discriminator_config_round_trips():
    jcfg, tcfg = _cfgs(c_dim=3, num_fp16_res=2, conv_clamp=256,
                       packed_first_block=True)
    data = jconfig.to_dict(jcfg)
    assert tconfig.discriminator_config_from_dict(data) == tcfg
    assert jconfig.discriminator_config_from_dict(
        tconfig.to_dict(tcfg)) == jcfg


def test_remat_and_spatial_constraint_raise():
    _, tcfg = _cfgs()
    params = tsg.init_discriminator(tcfg, torch.Generator().manual_seed(0),
                                    "cpu")
    img = torch.zeros((2, 3, 32, 32))
    for change in ({"remat": True}, {"remat_min_res": 16}):
        with pytest.raises(NotImplementedError, match="remat"):
            tsg.discriminator_apply(dataclasses.replace(tcfg, **change),
                                    params, img)
    with pytest.raises(NotImplementedError, match="spatial"):
        tsg.discriminator_apply(tcfg, params, img,
                                spatial_constraint=lambda t: t)
    gcfg = tsg.SynthesisConfig(img_resolution=16, channel_base=256,
                               channel_max=16, w_dim=8)
    gparams = tsg.init_synthesis(torch.Generator().manual_seed(0), gcfg)
    ws = torch.zeros((1, gcfg.num_ws, 8))
    for change in ({"remat": True}, {"remat_min_res": 8}):
        with pytest.raises(NotImplementedError, match="remat"):
            tsg.synthesis_apply(dataclasses.replace(gcfg, **change), gparams,
                                ws)
