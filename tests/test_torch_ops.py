"""The port's torch ops (gagan_tpu_torch.ops) against the JAX package's
(gagan_tpu.ops) on the same numpy-seeded inputs, on the CPU.

Forward tolerance 2e-4 (the JAX suite's own); the two frameworks sum
convolutions in different orders, nothing else differs in float32.  The
gradients (end of file) are held to 1e-3 of max|grad|, the suite's own.
"""

import jax
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


# ----------------------------------------------------------------------------
# Gradients (the train step differentiates every op above, PL and R1 twice):
# d sum(w * op(x)) with respect to every input, against jax.grad, 1e-3 of
# each gradient's max|.| (the JAX suite's gradient tolerance).


def _grad_close(fn_t, fn_j, arrays, seed):
    """Gradients of sum(w * fn(*arrays)) in both packages."""
    out_shape = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays])).shape
    wts = np.random.RandomState(seed).randn(*out_shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(fn_j(*a) * wts),
                    argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (fn_t(*ts) * torch.from_numpy(wts)).sum().backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-12))


@pytest.mark.parametrize("up,down,padding", [(1, 1, 1), (2, 1, 1), (1, 2, 1),
                                             (2, 2, (1, 2, 0, -1))])
def test_upfirdn2d_grad(up, down, padding):
    x = np.random.RandomState(20).randn(2, 3, 10, 10).astype(np.float32)
    f = [1.0, 3.0, 3.0, 1.0]
    _grad_close(
        lambda x: tud.upfirdn2d(x, tud.setup_filter(f), up=up, down=down,
                                padding=padding),
        lambda x: jops.upfirdn2d(x, jops.setup_filter(f), up=up, down=down,
                                 padding=padding), [x], 21)


@pytest.mark.parametrize("kernel,up,down,flip_weight", [
    (3, 1, 1, True), (3, 2, 1, False), (3, 1, 2, True), (1, 1, 2, True),
    (1, 2, 1, False)])
def test_conv2d_resample_grad(kernel, up, down, flip_weight):
    rng = np.random.RandomState(22)
    x = rng.randn(2, 4, 12, 12).astype(np.float32)
    w = rng.randn(5, 4, kernel, kernel).astype(np.float32)
    f = [1, 3, 3, 1]
    _grad_close(
        lambda x, w: tcr.conv2d_resample(x, w, f=tud.setup_filter(f), up=up,
                                         down=down, padding=kernel // 2,
                                         flip_weight=flip_weight),
        lambda x, w: jops.conv2d_resample(x, w, f=jops.setup_filter(f), up=up,
                                          down=down, padding=kernel // 2,
                                          flip_weight=flip_weight),
        [x, w], 23)


@pytest.mark.parametrize("act,clamp", [("lrelu", 0.5), ("lrelu", None),
                                       ("linear", 0.3)])
def test_bias_act_grad(act, clamp):
    rng = np.random.RandomState(24)
    x = rng.randn(3, 6, 5, 5).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    _grad_close(lambda x, b: tba.bias_act(x, b, act=act, clamp=clamp),
                lambda x, b: jops.bias_act(x, b, act=act, clamp=clamp),
                [x, b], 25)


@pytest.mark.parametrize("up,demodulate", [(1, True), (2, True), (1, False)])
def test_modulated_conv2d_grad(up, demodulate):
    rng = np.random.RandomState(26)
    x = rng.randn(2, 5, 8, 8).astype(np.float32)
    w = rng.randn(6, 5, 3, 3).astype(np.float32)
    s = (rng.randn(2, 5) * 0.3 + 1).astype(np.float32)
    f = [1, 3, 3, 1]
    kw = dict(up=up, padding=1, demodulate=demodulate, flip_weight=up == 1)
    _grad_close(
        lambda x, w, s: tmc.modulated_conv2d(
            x, w, s, resample_filter=tud.setup_filter(f) if up > 1 else None,
            **kw),
        lambda x, w, s: jops.modulated_conv2d(
            x, w, s, resample_filter=jops.setup_filter(f) if up > 1 else None,
            **kw), [x, w, s], 27)


@pytest.mark.parametrize("which", ["conv3x3", "upconv", "downconv",
                                   "down1x1", "conv1x1", "torgb"])
def test_packed_conv_grad(which):
    rng = np.random.RandomState(28)
    f = np.asarray([1, 3, 3, 1], np.float32) / 8
    tf, jf = torch.from_numpy(f), jnp.asarray(f)
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    if which in ("conv3x3", "downconv"):
        w = rng.randn(3, 4, 3, 3).astype(np.float32)
    elif which == "upconv":
        w = rng.randn(3, 4, 3, 3).astype(np.float32)
    elif which == "torgb":
        x = rng.randn(2, 16, 4, 4).astype(np.float32)
        w = rng.randn(3, 4).astype(np.float32)
    else:
        w = rng.randn(3, 4, 1, 1).astype(np.float32)
    build_t = {"conv3x3": tpk.build_packed_conv3x3,
               "upconv": lambda w: tpk.build_packed_upconv(w, tf),
               "downconv": lambda w: tpk.build_packed_downconv(w, tf),
               "down1x1": lambda w: tpk.build_packed_down1x1(w, tf),
               "conv1x1": tpk.build_packed_conv1x1,
               "torgb": tpk.build_torgb_transposed}[which]
    build_j = {"conv3x3": jpk.build_packed_conv3x3,
               "upconv": lambda w: jpk.build_packed_upconv(w, jf),
               "downconv": lambda w: jpk.build_packed_downconv(w, jf),
               "down1x1": lambda w: jpk.build_packed_down1x1(w, jf),
               "conv1x1": jpk.build_packed_conv1x1,
               "torgb": jpk.build_torgb_transposed}[which]
    if which == "torgb":
        fn_t = lambda x, w: tpk.conv_transposed_unpack(x, build_t(w))  # noqa
        fn_j = lambda x, w: jpk.conv_transposed_unpack(x, build_j(w))  # noqa
    elif which == "upconv":
        fn_t = lambda x, w: tpk.conv_packed(x, build_t(w))  # noqa
        fn_j = lambda x, w: jpk.conv_packed(x, build_j(w))  # noqa
    else:
        fn_t = lambda x, w: tpk.conv_packed(tpk.pack(x), build_t(w))  # noqa
        fn_j = lambda x, w: jpk.conv_packed(jpk.pack(x), build_j(w))  # noqa
    _grad_close(fn_t, fn_j, [x, w], 29)


# ----------------------------------------------------------------------------
# conv2d_gradfix: the stock convolution's values and gradients, to second
# order (float64, so only the algorithm could differ: 1e-10).


@pytest.mark.parametrize("transposed,stride,padding,groups", [
    (False, 1, 1, 1), (False, 2, 1, 1), (False, 1, 0, 3), (True, 2, 1, 1),
    (True, 2, 0, 3), (True, 1, 1, 1)])
def test_conv2d_gradfix_matches_stock_to_second_order(transposed, stride,
                                                      padding, groups):
    from gagan_tpu_torch.ops import conv2d_gradfix as gf

    rng = np.random.RandomState(30)
    x = torch.from_numpy(rng.randn(2, 6, 7, 7)).requires_grad_()
    # [C_out, C_in / groups, 3, 3], or [C_in, C_out / groups, 3, 3]
    # transposed: 6 channels in and out either way.
    w = torch.from_numpy(rng.randn(6, 6 // groups, 3, 3)).requires_grad_()
    if transposed:
        ours = lambda x, w: gf.conv_transpose2d(  # noqa: E731
            x, w, stride=stride, padding=padding, output_padding=stride - 1,
            groups=groups)
        stock = lambda x, w: torch.nn.functional.conv_transpose2d(  # noqa
            x, w, stride=stride, padding=padding, output_padding=stride - 1,
            groups=groups)
    else:
        ours = lambda x, w: gf.conv2d(x, w, stride=stride, padding=padding,  # noqa
                                      groups=groups)
        stock = lambda x, w: torch.nn.functional.conv2d(  # noqa: E731
            x, w, stride=stride, padding=padding, groups=groups)
    results = []
    for fn in (ours, stock):
        y = fn(x, w)
        gx, gw = torch.autograd.grad(y.square().sum(), (x, w),
                                     create_graph=True)
        hx, hw = torch.autograd.grad(gx.square().sum() + gw.sin().sum(),
                                     (x, w))
        results.append((y, gx, gw, hx, hw))
    for a, b in zip(*results):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-10, atol=1e-10)
