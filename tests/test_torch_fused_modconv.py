"""The port's fused modconv level (gagan_tpu_torch.ops.fused_modconv) against
the JAX package's Pallas kernel, which runs under the Pallas interpreter on
the CPU.  On the CPU the port runs the kernel's plain PyTorch version.

Tolerances: float32 2e-4 (summation order only); bfloat16 one bf16 ulp of
max|y|, since both sides fold the taps to bf16 and sum in fp32, so the sums
differ in order only and round at most one ulp apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.ops import pallas_modconv as pmc
from gagan_tpu_torch.ops import fused_modconv as fmc

torch.set_num_threads(2)


def _inputs(seed=3, n=2, c=128, h=8, w=128):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(n, c, h, w).astype(np.float32),
        w=(rng.randn(c, c, 3, 3) * 0.05).astype(np.float32),
        s=(rng.randn(n, c) * 0.3 + 1.0).astype(np.float32),
        b=(rng.randn(c) * 0.1).astype(np.float32),
        nz=(rng.randn(n, 1, h, w) * 0.05).astype(np.float32))


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("demodulate", [True, False])
@pytest.mark.parametrize("noise", [True, False])
def test_fused_level_matches_pallas(dtype, demodulate, noise):
    a = _inputs()
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    assert pmc.supported_shape(a["x"].shape, a["w"].shape)
    want = pmc.fused_modconv_level(
        jnp.asarray(a["x"]).astype(jdt), jnp.asarray(a["w"]),
        jnp.asarray(a["s"]), jnp.asarray(a["b"]),
        noise=jnp.asarray(a["nz"]) if noise else None, demodulate=demodulate)
    want = np.asarray(want.astype(jnp.float32))
    got = fmc.fused_modconv_level(
        torch.from_numpy(a["x"]).to(tdt), torch.from_numpy(a["w"]),
        torch.from_numpy(a["s"]), torch.from_numpy(a["b"]),
        noise=torch.from_numpy(a["nz"]) if noise else None,
        demodulate=demodulate)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    got = got.float().numpy()
    tol = 2e-4 if dtype == "float32" else _bf16_ulp(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_taps_rounds_once_after_the_fp32_fold(dtype):
    """The kernel's first launch: taps[n, ky*3+kx, o, i] = dtype((w * s) * d)."""
    a = _inputs(n=2, c=32, h=4)
    w = torch.from_numpy(a["w"])
    s = torch.from_numpy(a["s"])
    d = fmc.demod_coefs(w, s)
    taps = fmc.fold_taps(w, s, d, dtype)
    assert taps.dtype == dtype and tuple(taps.shape) == (2, 9, 32, 32)
    want = (a["w"][None] * a["s"][:, None, :, None, None]).astype(np.float32)
    want = want * d.numpy()[:, :, None, None, None]
    want = torch.from_numpy(want.reshape(2, 32, 32, 9).transpose(0, 3, 1, 2)
                            .copy()).to(dtype)
    assert torch.equal(taps, want)


def _vjp_inputs(a, noise, tdt, jdt):
    """The level's inputs and an output gradient, for both packages."""
    rng = np.random.RandomState(7)
    n, c, h, w = a["x"].shape
    d = 1.0 / np.sqrt((a["s"][:, None, :] ** 2
                       * (a["w"] ** 2).sum((2, 3))[None]).sum(-1) + 1e-8)
    g = rng.randn(n, c, h, w).astype(np.float32)
    arrays = [a["x"], a["w"], a["s"], d.astype(np.float32),
              a["nz"] if noise else None, a["b"]]
    jin = [None if v is None else jnp.asarray(v) for v in arrays]
    jin[0] = jin[0].astype(jdt)
    tin = [None if v is None else torch.from_numpy(v).requires_grad_()
           for v in arrays]
    tin[0] = torch.from_numpy(a["x"]).to(tdt).requires_grad_()
    return jin, tin, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("noise", [True, False])
def test_backward_matches_pallas_vjp(dtype, noise):
    """The level's backward against jax.vjp of the Pallas custom VJP (its
    forward interpreted).  float32: 1e-3 of each gradient's max|.|, the JAX
    suite's gradient tolerance.  bfloat16: both sides round u, du and the
    transposed conv's output to bf16 at the same places but sum the convs
    in other orders, so a value may land a bf16 rounding (2^-8 relative)
    apart and carry it into fp32 reductions: 2^-6 of max|.|."""
    a = _inputs(n=2, c=128, h=6)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jin, tin, g = _vjp_inputs(a, noise, tdt, jdt)
    diff = [i for i, v in enumerate(jin) if v is not None]

    def f(*args):
        full = list(jin)
        for i, v in zip(diff, args):
            full[i] = v
        return pmc.fused_modconv3x3(*full, clamp=3.0)

    y, vjp = jax.vjp(f, *[jin[i] for i in diff])
    want = vjp(jnp.asarray(g).astype(jdt))
    got_y = fmc.fused_modconv3x3(*tin, clamp=3.0)
    got_y.backward(torch.from_numpy(g).to(tdt))
    assert float(jnp.mean(jnp.abs(y.astype(jnp.float32)) >= 3.0)) > 0.01
    tol = 1e-3 if dtype == "float32" else 2.0 ** -6
    for i, wv in zip(diff, want):
        gt = tin[i].grad
        assert gt.dtype == (tdt if i == 0 else torch.float32)
        wv = np.asarray(wv.astype(jnp.float32))
        np.testing.assert_allclose(gt.float().numpy(), wv, rtol=0,
                                   atol=tol * np.abs(wv).max())


def test_raises_on_requires_grad():
    """The backward is first-order only, like the JAX custom VJP: a double
    backward through the level raises instead of returning a wrong value;
    a first-order backward and a forward without autograd are fine."""
    a = _inputs(n=1, h=4)
    x = torch.from_numpy(a["x"]).requires_grad_()
    args = (torch.from_numpy(a["w"]), torch.from_numpy(a["s"]),
            torch.from_numpy(a["b"]))
    y = fmc.fused_modconv_level(x, *args)
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        gx.sum().backward()
    with torch.no_grad():
        fmc.fused_modconv_level(x, *args)


def test_cpu_tensors_never_take_the_cuda_path(monkeypatch):
    def no_cuda():
        raise AssertionError("CUDA kernel path taken for CPU tensors")

    monkeypatch.setattr(fmc, "_lib", no_cuda)
    before = fmc.fused_modconv3x3.launches
    a = _inputs(n=1, h=4)
    y = fmc.fused_modconv_level(torch.from_numpy(a["x"]),
                                torch.from_numpy(a["w"]),
                                torch.from_numpy(a["s"]),
                                torch.from_numpy(a["b"]),
                                noise=torch.from_numpy(a["nz"][:, :, :4]))
    assert y.device.type == "cpu"
    assert fmc.fused_modconv3x3.launches == before


def test_predicate_covers_pallas_scope():
    """Every level the Pallas kernel takes, the Hopper kernel takes too."""
    taken = 0
    for c in (48, 64, 128, 256, 512):
        for h in (2, 3, 4, 8, 16, 128):
            for w in (64, 128, 160, 256, 384):
                shape = (2, c, h, w)
                for w_shape in ((c, c, 3, 3), (2 * c, c, 3, 3)):
                    if pmc.supported_shape(shape, w_shape):
                        taken += 1
                        assert fmc.supported_shape(shape, w_shape), shape
                assert not fmc.supported_shape(shape, (c, c, 3, 3), up=2)
                assert not fmc.supported_shape(shape, (c, c, 1, 1))
    assert taken > 0
    # Wider than the TPU tiling: W not a multiple of 128, C_in of 16, any H.
    assert fmc.supported_shape((2, 48, 7, 136), (128, 48, 3, 3))
    assert not pmc.supported_shape((2, 48, 7, 136), (128, 48, 3, 3))


def test_predicate_at_ffhq1024():
    """At FFHQ-1024 the kernel serves b128.conv1 and b256.conv1."""
    chans = {4: 512, 8: 512, 16: 512, 32: 512, 64: 512, 128: 256, 256: 128,
             512: 64}
    served = [r for r, c in chans.items()
              if fmc.supported_shape((8, c, r, r), (c, c, 3, 3))]
    assert served == [128, 256]



def test_other_devices_are_refused():
    x = torch.empty((1, 16, 4, 128), device="meta")
    w = torch.empty((128, 16, 3, 3), device="meta")
    s = torch.empty((1, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fmc.fused_modconv_level(x, w, s, torch.empty(128, device="meta"))


def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    from gagan_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    # Libraries are named by a hash of their source and flags.
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    first = _build._lib_path(str(src))
    src.write_text("// b\n")
    assert _build._lib_path(str(src)) != first
