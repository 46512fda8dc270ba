"""The port's torch ops (gagan_tpu_torch.ops) against the JAX package's
(gagan_tpu.ops) on the same numpy-seeded inputs, on the CPU.

Forward tolerance 2e-4 (the JAX suite's own); the two frameworks sum
convolutions in different orders, nothing else differs in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu import ops as jops
from gagan_tpu.ops import packed as jpk
from gagan_tpu_torch.ops import bias_act as tba
from gagan_tpu_torch.ops import conv2d_resample as tcr
from gagan_tpu_torch.ops import modulated_conv2d as tmc
from gagan_tpu_torch.ops import packed as tpk
from gagan_tpu_torch.ops import upfirdn2d as tud

torch.set_num_threads(2)

TOL = 2e-4


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("up,down,padding", [
    (1, 1, 0),
    (1, 1, 2),
    (2, 1, 1),
    (1, 2, 1),
    (2, 1, (2, 1)),
    (1, 1, (1, 2, 3, 4)),
    (2, 2, (1, 1, 1, 1)),
    (1, 1, (-1, -1, -1, -1)),
    (2, 1, (-1, 2, 0, -2)),
    (4, 1, 2),
    (1, 4, 2),
])
@pytest.mark.parametrize("sep", [True, False])
def test_upfirdn2d(up, down, padding, sep):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 12, 12).astype(np.float32)
    taps = np.asarray([1.0, 3.0, 3.0, 1.0], dtype=np.float32)
    f = taps if sep else np.outer(taps, taps)
    want = jops.upfirdn2d(jnp.asarray(x), jops.setup_filter(f), up=up,
                          down=down, padding=padding, gain=1.5)
    got = tud.upfirdn2d(torch.from_numpy(x), tud.setup_filter(f), up=up,
                        down=down, padding=padding, gain=1.5)
    close(got, want)


@pytest.mark.parametrize("flip_filter", [False, True])
def test_upfirdn2d_flip_filter(flip_filter):
    rng = np.random.RandomState(1)
    x = rng.randn(1, 2, 9, 9).astype(np.float32)
    f = np.asarray([[1.0, 2.0], [3.0, 4.0]], dtype=np.float32)
    want = jops.upfirdn2d(jnp.asarray(x), jops.setup_filter(f), up=2,
                          padding=1, flip_filter=flip_filter)
    got = tud.upfirdn2d(torch.from_numpy(x), tud.setup_filter(f), up=2,
                        padding=1, flip_filter=flip_filter)
    close(got, want)


@pytest.mark.parametrize("f", [[1, 3, 3, 1], [1, 2, 1]])
def test_setup_filter(f):
    close(tud.setup_filter(f), jops.setup_filter(f), tol=1e-7)
    close(tud.setup_filter(f, flip_filter=True, gain=4),
          jops.setup_filter(f, flip_filter=True, gain=4), tol=1e-7)


@pytest.mark.parametrize("which", ["up", "down"])
@pytest.mark.parametrize("sep", [True, False])
def test_up_down_sample2d(which, sep):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    f = [1, 3, 3, 1]
    jf = jops.setup_filter(f, separable=sep)
    tf = tud.setup_filter(f, separable=sep)
    jfn, tfn = ((jops.upsample2d, tud.upsample2d) if which == "up"
                else (jops.downsample2d, tud.downsample2d))
    close(tfn(torch.from_numpy(x), tf), jfn(jnp.asarray(x), jf))


@pytest.mark.parametrize("act", sorted(jops.activation_funcs))
@pytest.mark.parametrize("gain,clamp", [(None, None), (0.5, None),
                                        (None, 0.4), (2.0, 1.0)])
def test_bias_act(act, gain, clamp):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 8, 5, 5).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    want = jops.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, gain=gain,
                         clamp=clamp)
    got = tba.bias_act(torch.from_numpy(x), torch.from_numpy(b), act=act,
                       gain=gain, clamp=clamp)
    # XLA's vectorized transcendentals differ from torch's by ~1e-4 relative.
    close(got, want, tol=1e-5 if act in ("linear", "relu", "lrelu") else 5e-4)


def test_bias_act_dim():
    rng = np.random.RandomState(4)
    x = rng.randn(4, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    close(tba.bias_act(torch.from_numpy(x), torch.from_numpy(b), dim=1,
                       act="lrelu"),
          jops.bias_act(jnp.asarray(x), jnp.asarray(b), dim=1, act="lrelu"),
          tol=1e-5)


def test_bias_act_bf16_rounds_like_jax():
    # The slope and gain are rounded to bf16 before the multiply, as JAX
    # rounds a Python scalar to the array's dtype: bit-equal results.
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, 6, 6).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    want = jops.bias_act(jnp.asarray(x).astype(jnp.bfloat16),
                         jnp.asarray(b).astype(jnp.bfloat16), act="lrelu",
                         clamp=256.0)
    got = tba.bias_act(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(b).bfloat16(), act="lrelu",
                       clamp=256.0)
    close(got, want, tol=0.0)


@pytest.mark.parametrize("kernel,up,down,padding,flip_weight", [
    (3, 1, 1, 1, True),
    (3, 2, 1, 1, False),   # synthesis up-conv configuration
    (3, 1, 2, 1, True),    # discriminator down-conv configuration
    (1, 1, 1, 0, True),    # torgb
    (1, 1, 2, 0, True),    # 1x1 skip with down
    (1, 2, 1, 0, False),   # 1x1 with up
    (4, 2, 1, 0, False),
    (3, 2, 2, 1, False),
    (3, 4, 1, 1, False),
    (3, 2, 1, 1, True),
    (3, 1, 1, 1, False),
])
def test_conv2d_resample(kernel, up, down, padding, flip_weight):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 16, 16).astype(np.float32)
    w = rng.randn(7, 5, kernel, kernel).astype(np.float32)
    f = [1, 3, 3, 1]
    want = jops.conv2d_resample(jnp.asarray(x), jnp.asarray(w),
                                f=jops.setup_filter(f), up=up, down=down,
                                padding=padding, flip_weight=flip_weight)
    got = tcr.conv2d_resample(torch.from_numpy(x), torch.from_numpy(w),
                              f=tud.setup_filter(f), up=up, down=down,
                              padding=padding, flip_weight=flip_weight)
    close(got, want)


@pytest.mark.parametrize("up", [1, 2])
def test_conv2d_resample_groups(up):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 6, 10, 10).astype(np.float32)
    w = rng.randn(8, 3, 3, 3).astype(np.float32)  # 2 groups
    f = [1, 3, 3, 1]
    want = jops.conv2d_resample(jnp.asarray(x), jnp.asarray(w),
                                f=jops.setup_filter(f), up=up, padding=1,
                                groups=2, flip_weight=up == 1)
    got = tcr.conv2d_resample(torch.from_numpy(x), torch.from_numpy(w),
                              f=tud.setup_filter(f), up=up, padding=1,
                              groups=2, flip_weight=up == 1)
    close(got, want)


@pytest.mark.parametrize("demodulate,up,noise,prenorm", [
    (True, 1, False, False),
    (True, 1, True, False),
    (False, 1, False, False),
    (False, 1, True, False),
    (True, 2, True, False),
    (True, 2, False, False),
    (True, 1, False, True),
])
def test_modulated_conv2d(demodulate, up, noise, prenorm):
    rng = np.random.RandomState(7)
    n, ci, co, k, res = 2, 6, 9, 3, 8
    x = rng.randn(n, ci, res, res).astype(np.float32)
    w = rng.randn(co, ci, k, k).astype(np.float32)
    s = rng.randn(n, ci).astype(np.float32)
    nz = rng.randn(n, co, res * up, res * up).astype(np.float32) if noise else None
    f = [1, 3, 3, 1]
    want = jops.modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
        noise=jnp.asarray(nz) if noise else None, up=up, padding=k // 2,
        resample_filter=jops.setup_filter(f) if up > 1 else None,
        demodulate=demodulate, flip_weight=(up == 1), input_prenorm=prenorm)
    got = tmc.modulated_conv2d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s),
        noise=torch.from_numpy(nz) if noise else None, up=up, padding=k // 2,
        resample_filter=tud.setup_filter(f) if up > 1 else None,
        demodulate=demodulate, flip_weight=(up == 1), input_prenorm=prenorm)
    close(got, want)


# ----------------------------------------------------------------------------
# Packed tail helpers


def test_pack_unpack_and_channel_tile():
    rng = np.random.RandomState(8)
    x = rng.randn(2, 3, 8, 6).astype(np.float32)
    close(tpk.pack(torch.from_numpy(x)), jpk.pack(jnp.asarray(x)), tol=0)
    xp = rng.randn(2, 12, 4, 3).astype(np.float32)
    close(tpk.unpack(torch.from_numpy(xp)), jpk.unpack(jnp.asarray(xp)), tol=0)
    assert torch.equal(tpk.unpack(tpk.pack(torch.from_numpy(x))),
                       torch.from_numpy(x))
    v = rng.randn(2, 5).astype(np.float32)
    close(tpk.pack_channel_tile(torch.from_numpy(v)),
          jpk.pack_channel_tile(jnp.asarray(v)), tol=0)


@pytest.mark.parametrize("i,p,a_range,offset", [
    (i, p, a, o) for i in range(2) for p in range(2) for a, o in ((3, 1), (6, 3))])
def test_cell_tap(i, p, a_range, offset):
    assert tpk._cell_tap(i, p, a_range, offset) == jpk._cell_tap(
        i, p, a_range, offset)


def test_packed_kernel_builders():
    rng = np.random.RandomState(9)
    w = rng.randn(3, 5, 3, 3).astype(np.float32)
    f = np.asarray([1, 3, 3, 1], np.float32) / 8
    w1 = rng.randn(3, 5).astype(np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    close(tpk.build_packed_conv3x3(tw), jpk.build_packed_conv3x3(jw), tol=0)
    close(tpk.build_packed_upconv(tw, torch.from_numpy(f)),
          jpk.build_packed_upconv(jw, jnp.asarray(f)), tol=1e-6)
    close(tpk.build_packed_fir_upsample(torch.from_numpy(f), 3),
          jpk.build_packed_fir_upsample(jnp.asarray(f), 3), tol=0)
    close(tpk.build_torgb_transposed(torch.from_numpy(w1)),
          jpk.build_torgb_transposed(jnp.asarray(w1)), tol=0)


def test_packed_convs():
    rng = np.random.RandomState(10)
    x = rng.randn(2, 5, 8, 8).astype(np.float32)
    w = rng.randn(3, 5, 3, 3).astype(np.float32)
    f = np.asarray([1, 3, 3, 1], np.float32) / 8
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    tf, jf = torch.from_numpy(f), jnp.asarray(f)
    # Packed 3x3 == pack(conv): the port's packed conv against JAX's.
    close(tpk.conv_packed(tpk.pack(tx), tpk.build_packed_conv3x3(tw)),
          jpk.conv_packed(jpk.pack(jx), jpk.build_packed_conv3x3(jw)))
    # Composed up-conv from the unpacked input.
    close(tpk.conv_packed(tx, tpk.build_packed_upconv(tw, tf)),
          jpk.conv_packed(jx, jpk.build_packed_upconv(jw, jf)))
    # FIR upsample straight to the packed layout.
    close(tpk.fir_upsample_packed(tx, tf), jpk.fir_upsample_packed(jx, jf))
    # torgb + depth-to-space as one input-dilated conv.
    h = rng.randn(2, 20, 4, 4).astype(np.float32)
    w1 = rng.randn(3, 5).astype(np.float32)
    close(tpk.conv_transposed_unpack(
              torch.from_numpy(h), tpk.build_torgb_transposed(torch.from_numpy(w1))),
          jpk.conv_transposed_unpack(
              jnp.asarray(h), jpk.build_torgb_transposed(jnp.asarray(w1))))


def test_packed_upconv_is_exact_reformulation():
    # The packed up-conv equals pack(conv2d_resample(up=2)) within the port.
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(2, 4, 6, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(5, 4, 3, 3).astype(np.float32))
    f = tud.setup_filter([1, 3, 3, 1])
    ref = tcr.conv2d_resample(x, w, f=f, up=2, padding=1, flip_weight=False)
    taps = torch.tensor([1.0, 3.0, 3.0, 1.0]) / 8
    got = tpk.conv_packed(x, tpk.build_packed_upconv(w, taps))
    np.testing.assert_allclose(got.numpy(), tpk.pack(ref).numpy(),
                               rtol=TOL, atol=TOL)
