"""Block rematerialization in the port's G and D (``remat`` /
``remat_min_res`` under torch.utils.checkpoint) against the plain path of the
same function: outputs, first-order gradients, and the second-order
gradients of R1 (through D) and of the path-length penalty (through G), on
the same weights and draws.  The recomputation runs the same ops on the same
inputs, so the values agree to 1e-6 relative (float summation order is the
only freedom).  Also: the remat fields round-trip through the JAX package's
configs, and a remat'd block runs the fused level's forward again in the
backward."""

import dataclasses

import numpy as np
import pytest
import torch

from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.ops import fused_modconv as fmc
from gagan_tpu_torch.train import gan_loss as tgl
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils import config as tconfig
from gagan_tpu_torch.utils.rng import Rng

torch.set_num_threads(2)

REMAT = {"plain": {}, "all": {"remat": True}, "min16": {"remat_min_res": 16},
         "min64": {"remat_min_res": 64}}


def _g_cfg(remat=None, packed=True, pallas=False, fp16=0):
    return tsg.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=32,
        mapping=tsg.MappingConfig(num_layers=2),
        synthesis=tsg.SynthesisConfig(
            channel_base=512, channel_max=32, packed_last_block=packed,
            pallas_level=pallas, num_fp16_res=fp16,
            conv_clamp=256 if fp16 else None, **(remat or {})))


def _d_cfg(remat=None, packed=2, fp16=0):
    return tsg.DiscriminatorConfig(
        img_resolution=32, channel_base=512, channel_max=32,
        mbstd_group_size=2, packed_first_block=packed > 0,
        packed_head_blocks=max(packed, 1), num_fp16_res=fp16,
        conv_clamp=256 if fp16 else None, **(remat or {}))


def _params(init, cfg, seed):
    params = init(cfg, torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 100)
    for k, t in tck.tree_to_flat_tensors(params).items():
        if k.endswith("noise_strength"):
            t.fill_(0.2)
        elif k.endswith(".bias") and ".affine." not in k:
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    return params


def _grads(loss_fn, params):
    leaves = {k: t for k, t in tck.tree_to_flat_tensors(params).items()
              if not k.endswith(("w_avg", "noise_const"))}
    for t in leaves.values():
        t.requires_grad_(True)
        t.grad = None
    try:
        out = loss_fn()
        out.backward()
        grads = {k: (t.grad.clone() if t.grad is not None
                     else torch.zeros_like(t)) for k, t in leaves.items()}
    finally:
        for t in leaves.values():
            t.grad = None
            t.requires_grad_(False)
    return out.detach(), grads


def _same(got, want, what):
    for k, w in want.items():
        g = got[k].float()
        w = w.float()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * max(float(w.abs().max()), 1e-6),
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", ["all", "min16", "min64"])
@pytest.mark.parametrize("variant", ["packed", "unpacked_bf16", "pallas"])
def test_generator_remat_matches_plain(variant, name):
    """Image and d(sum w * img) with respect to every G leaf; random noise
    from an Rng key, so the recomputed blocks must draw it again."""
    kw = dict(packed=variant != "unpacked_bf16",
              fp16=2 if variant == "unpacked_bf16" else 0,
              pallas=variant == "pallas")
    plain, remat = _g_cfg(None, **kw), _g_cfg(REMAT[name], **kw)
    params = _params(tsg.init_generator, plain, 0)
    z = torch.randn((2, 32), generator=torch.Generator().manual_seed(1))
    wts = torch.randn((2, 3, 32, 32), generator=torch.Generator().manual_seed(2))
    out = {}
    for label, cfg in (("plain", plain), ("remat", remat)):
        out[label] = _grads(lambda: (tsg.generator_apply(
            cfg, params, z, noise_mode="random", generator=Rng(3))
            * wts).sum(), params)
    _same({"img": out["remat"][0]}, {"img": out["plain"][0]}, "forward")
    _same(out["remat"][1], out["plain"][1], "grad")


@pytest.mark.parametrize("name", ["all", "min16", "min64"])
@pytest.mark.parametrize("packed,fp16", [(0, 0), (2, 0), (1, 2)])
def test_discriminator_remat_matches_plain(packed, fp16, name):
    plain, remat = _d_cfg(None, packed, fp16), _d_cfg(REMAT[name], packed, fp16)
    params = _params(tsg.init_discriminator, plain, 4)
    img = torch.randn((4, 3, 32, 32), generator=torch.Generator().manual_seed(5))
    wts = torch.randn((4, 1), generator=torch.Generator().manual_seed(6))
    out = {}
    for label, cfg in (("plain", plain), ("remat", remat)):
        x = img.clone().requires_grad_()
        logits, grads = _grads(
            lambda: (tsg.discriminator_apply(cfg, params, x) * wts).sum(),
            params)
        out[label] = (logits, grads, x.grad)
    _same({"out": out["remat"][0], "dimg": out["remat"][2]},
          {"out": out["plain"][0], "dimg": out["plain"][2]}, "D")
    _same(out["remat"][1], out["plain"][1], "grad")


@pytest.mark.parametrize("name", ["all", "min16"])
def test_r1_through_remat_discriminator(name):
    """The R1 penalty's gradient: autograd.grad(create_graph=True) through
    the checkpointed blocks, then a second backward."""
    plain, remat = _d_cfg(None, 2), _d_cfg(REMAT[name], 2)
    params = _params(tsg.init_discriminator, plain, 7)
    real = torch.rand((4, 3, 32, 32), generator=torch.Generator().manual_seed(8))
    out = {}
    for label, cfg in (("plain", plain), ("remat", remat)):
        out[label] = _grads(lambda: tgl.d_r1_loss(
            tgl.GANLossConfig(r1_gamma=1.0), cfg, params, real, None,
            Rng(9))[0], params)
    _same({"r1": out["remat"][0]}, {"r1": out["plain"][0]}, "R1")
    _same(out["remat"][1], out["plain"][1], "R1 grad")
    assert any(float(g.abs().max()) > 0 for g in out["remat"][1].values())


@pytest.mark.parametrize("name", ["all", "min16"])
def test_pl_through_remat_generator(name):
    """The path-length penalty's gradient through checkpointed blocks with
    random noise (pallas_level off, as the Greg phase runs)."""
    plain, remat = _g_cfg(), _g_cfg(REMAT[name])
    params = _params(tsg.init_generator, plain, 10)
    z = torch.randn((4, 32), generator=torch.Generator().manual_seed(11))
    out = {}
    for label, cfg in (("plain", plain), ("remat", remat)):
        out[label] = _grads(lambda: tgl.g_pl_loss(
            tgl.GANLossConfig(), cfg, params, z, None, Rng(12),
            torch.tensor(0.5))[0], params)
    _same({"pl": out["remat"][0]}, {"pl": out["plain"][0]}, "PL")
    _same(out["remat"][1], out["plain"][1], "PL grad")


def test_remat_runs_the_fused_forward_again(monkeypatch):
    """Under G remat the fused level's forward runs twice per level: once
    in the forward and once when the backward recomputes the block."""
    calls = []
    orig = fmc._forward
    monkeypatch.setattr(fmc, "_forward",
                        lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setattr(fmc, "supported_shape", lambda *a, **k: True)
    counts = {}
    for label, remat in (("plain", None), ("remat", {"remat": True})):
        cfg = _g_cfg(remat, packed=True, pallas=True)
        params = _params(tsg.init_generator, cfg, 13)
        z = torch.randn((2, 32), generator=torch.Generator().manual_seed(14))
        calls.clear()
        _grads(lambda: tsg.generator_apply(cfg, params, z).sum(), params)
        counts[label] = len(calls)
    # 8^2 and 16^2 conv1 (the 4^2 conv1 too); the 32^2 tail is packed.
    assert counts == {"plain": 3, "remat": 6}


def test_remat_fields_round_trip_with_jax():
    for field_kw in ({"remat": True}, {"remat_min_res": 64}):
        tg = dataclasses.replace(
            tsg.GeneratorConfig(img_resolution=64),
            synthesis=tsg.SynthesisConfig(**field_kw))
        jg = dataclasses.replace(
            jsg.GeneratorConfig(img_resolution=64),
            synthesis=jsg.SynthesisConfig(**field_kw))
        assert jconfig.generator_config_from_dict(tconfig.to_dict(tg)) == jg
        assert tconfig.generator_config_from_dict(jconfig.to_dict(jg)) == tg
        td, jd = tsg.DiscriminatorConfig(**field_kw), jsg.DiscriminatorConfig(
            **field_kw)
        assert jconfig.discriminator_config_from_dict(
            tconfig.to_dict(td)) == jd
        assert tconfig.discriminator_config_from_dict(
            jconfig.to_dict(jd)) == td
