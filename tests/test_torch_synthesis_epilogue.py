"""The synthesis layers' one-pass epilogue (ops/synthesis_epilogue.py) on
the CPU: its plain version against the composed chain it replaces, the
routing predicate, and a tiny generator forward routed through it.  The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py's ``epilogue`` phase."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from gagan_tpu_torch import entry
from gagan_tpu_torch.models import stylegan2 as sg2
from gagan_tpu_torch.ops import synthesis_epilogue as se
from gagan_tpu_torch.ops.bias_act import bias_act
from gagan_tpu_torch.utils.rng import Rng

GAIN = float(np.sqrt(2.0))
N, C, H, W = 3, 8, 4, 6


def _inputs(noise_kind, dtype, seed=0):
    """c, d, b and the noise of one layer: absent, a const [H, W] buffer, a
    random [N, 1, H, W] draw, or 4 packed planes [1, 4, H, W]."""
    g = torch.Generator().manual_seed(seed)
    c = (torch.randn((N, C, H, W), generator=g) * 120).to(dtype)
    d = torch.rand((N, C), generator=g) * 1.5 + 0.5
    b = torch.randn((C,), generator=g)
    noise = {"none": None,
             "const": torch.randn((1, 1, H, W), generator=g),
             "random": torch.randn((N, 1, H, W), generator=g),
             "packed": torch.randn((1, 4, H, W), generator=g)}[noise_kind]
    return c, d, b, None if noise is None else noise.to(dtype)


def _composed(c, d, b, noise):
    """Today's chain: the demodulation multiply, the noise add (the packed
    tail's repeat_interleave), bias_act with the lrelu gain and clamp."""
    x = c * d.to(c.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.repeat_interleave(C // noise.shape[1], dim=1).to(c.dtype)
    return bias_act(x, b.to(c.dtype), act="lrelu", gain=GAIN, clamp=256.0)


def _bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs())) - 7)


NOISE = ("none", "const", "random", "packed")


@pytest.mark.parametrize("noise_kind", NOISE)
def test_plain_version_is_the_composed_chain_in_fp32(noise_kind):
    c, d, b, noise = _inputs(noise_kind, torch.float32)
    got = se.synthesis_epilogue(c, d, b, noise)
    assert got.dtype == torch.float32
    assert torch.equal(got, _composed(c, d, b, noise))
    assert float(got.abs().max()) == 256.0          # the clamp did work
    assert bool((got < 0).any())


@pytest.mark.parametrize("noise_kind", NOISE)
def test_plain_version_rounds_once_in_bf16(noise_kind):
    c, d, b, noise = _inputs(noise_kind, torch.bfloat16, seed=1)
    got = se.synthesis_epilogue(c, d, b, noise)
    assert got.dtype == torch.bfloat16
    want = _composed(c.float(), d, b,
                     None if noise is None else noise.float())
    err = (got.float() - want).abs()
    assert bool((want != 0).all())
    assert bool((err <= _bf16_ulp(want)).all()), float(
        (err / _bf16_ulp(want)).max())


@pytest.mark.parametrize("bad", ["strided c", "d bf16", "b shape",
                                 "noise planes", "noise dtype", "noise batch"])
def test_check_refuses_what_the_kernel_does_not_take(bad):
    c, d, b, noise = _inputs("packed", torch.bfloat16)
    if bad == "strided c":
        c = c.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "d bf16":
        d = d.to(torch.bfloat16)
    elif bad == "b shape":
        b = b[:-1]
    elif bad == "noise planes":
        noise = noise[:, :3]
    elif bad == "noise dtype":
        noise = noise.float()
    else:
        noise = noise.expand(2, -1, -1, -1).contiguous()
    with pytest.raises((TypeError, ValueError)):
        se._check(c, d, b, noise)
    c, d, b, noise = _inputs("packed", torch.bfloat16)
    se._check(c, d, b, noise)


def test_nbytes_counts_each_input_once():
    c, d, b, noise = _inputs("packed", torch.bfloat16)
    assert se.nbytes(c, d, b, noise) == (2 * N * C * H * W * 2
                                         + 4 * (N * C + C) + 4 * H * W * 2)
    assert se.nbytes(c.float(), d, b) == 2 * N * C * H * W * 4 + 4 * (N + 1) * C


def _as_cuda(t):
    """A stand-in that the predicate reads as a CUDA tensor."""
    return types.SimpleNamespace(is_cuda=True, dtype=t.dtype,
                                 requires_grad=t.requires_grad)


@pytest.mark.parametrize("case,want", [
    ("cpu tensor", False), ("cuda, no grad", True), ("other activation", False),
    ("float16", False), ("graph recorded", False), ("grad mode, no leaf", True),
    ("no_grad over a leaf", True)])
def test_predicate(case, want):
    x = torch.zeros(2, 3, 4, 4)
    w = torch.zeros(3, 3, 3, 3, requires_grad=case in (
        "graph recorded", "no_grad over a leaf"))
    s, b = torch.zeros(2, 3), torch.zeros(3)
    arg = x if case == "cpu tensor" else _as_cuda(
        x.half() if case == "float16" else x)
    act = "relu" if case == "other activation" else "lrelu"
    if case == "no_grad over a leaf":
        with torch.no_grad():
            assert se.applies(arg, act, s, w, b, None) is want
    else:
        assert se.applies(arg, act, s, w, b, None) is want


def _tiny_g(packed: bool):
    cfg = dataclasses.replace(
        entry.TINY_G, synthesis=dataclasses.replace(
            entry.TINY_G.synthesis, conv_clamp=256, packed_last_block=packed))
    params = sg2.init_generator(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        _seed_noise_and_bias(params["synthesis"], g)
    z = torch.randn((2, cfg.z_dim), generator=g)
    return cfg, params, z


def _seed_noise_and_bias(tree, g, path=()):
    """Non-zero noise strengths and synthesis biases, so both do work."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _seed_noise_and_bias(v, g, path + (k,))
        elif k == "noise_strength":
            v.copy_(torch.rand((), generator=g) * 0.25 + 0.05)
        elif k == "bias" and "affine" not in path:
            v.copy_(torch.randn(v.shape, generator=g) * 0.1)


def _route(monkeypatch, predicate):
    """Route the epilogue by ``predicate`` and count the plain version's
    calls (the kernel's stand-in on the CPU)."""
    calls = []
    ref = se.synthesis_epilogue_ref
    monkeypatch.setattr(se, "applies", predicate)
    monkeypatch.setattr(se, "synthesis_epilogue_ref",
                        lambda *a, **k: calls.append(1) or ref(*a, **k))
    return calls


def _forward(cfg, params, z, noise_mode, hooks=None):
    return sg2.generator_apply(cfg, params, z, noise_mode=noise_mode,
                               generator=Rng(5) if noise_mode == "random"
                               else None, hooks=hooks)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("noise_mode", ["const", "random"])
def test_tiny_generator_routed_equals_composed(monkeypatch, packed,
                                               noise_mode):
    cfg, params, z = _tiny_g(packed)
    with torch.no_grad():
        want = _forward(cfg, params, z, noise_mode)
        calls = _route(monkeypatch, lambda x, act, *t: act == "lrelu")
        got = _forward(cfg, params, z, noise_mode)
    # 32^2: b4.conv1 and two layers in each of b8, b16, b32.
    assert len(calls) == 7
    assert torch.equal(got, want)


def test_graph_recording_and_post_hooks_take_the_composed_path(monkeypatch):
    cfg, params, z = _tiny_g(packed=False)
    real = se.applies
    calls = _route(monkeypatch, lambda x, act, *t: real(_as_cuda(x), act, *t))
    params["synthesis"]["b16"]["conv0"]["bias"].requires_grad_(True)
    img = _forward(cfg, params, z, "const")     # a graph from b16.conv0 on
    assert len(calls) == 3 and img.requires_grad
    del calls[:]
    params["synthesis"]["b4"]["conv1"]["weight"].requires_grad_(True)
    img = _forward(cfg, params, z, "const")            # a graph from b4 on
    assert len(calls) == 0 and img.requires_grad
    with torch.no_grad():
        _forward(cfg, params, z, "const")
    assert len(calls) == 7
    del calls[:]
    hooks = {"b8.conv1": {"post": lambda x: x * 1.0}}
    with torch.no_grad():
        _forward(cfg, params, z, "const", hooks)
    assert len(calls) == 6
