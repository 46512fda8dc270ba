"""The packed tail over several blocks, the four multi-block packed
builders and the "orig" generator, against the JAX package on the CPU.

Builders: on seeded numpy weights, bit-equal where both only copy taps and
within 1e-6 where both sum the composed FIR kernel; their convolutions
within the suite's 2e-4.  Synthesis: 64^2, channels 32 (16 at 64^2), const
noise with non-zero strengths and biases, batch 2; forward within 2e-4 of
max|img|, gradients of sum(img * r) with respect to the ws and to every
synthesis leaf within 1e-3 of each leaf's max|grad| (the suite's own
tolerances, ``tests/test_ops_parity.py``).  Every packed variant is also
held against the port's own unpacked forward.
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
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.ops import conv2d_resample as tcr
from gagan_tpu_torch.ops import packed as tpk
from gagan_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

TOL = 2e-4
GRAD_TOL = 1e-3


def close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _inputs(seed=0, c_in=5, c_out=6, size=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, c_in, size, size).astype(np.float32)
    w = rng.randn(c_out, c_in, 3, 3).astype(np.float32)
    f = np.asarray([1.0, 3.0, 3.0, 1.0], np.float32) / 8.0
    return x, w, f


def test_multi_block_builders_match_jax():
    _, w, f = _inputs()
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    close(tpk.build_packed_conv2x2(tw), jpk.build_packed_conv2x2(jw), tol=0)
    close(tpk.build_packed_upconv_packed(tw, torch.from_numpy(f)),
          jpk.build_packed_upconv_packed(jw, jnp.asarray(f)), tol=1e-6)
    y = np.random.RandomState(1).randn(2, 16 * 3, 4, 5).astype(np.float32)
    close(tpk.repack_up(torch.from_numpy(y)), jpk.repack_up(jnp.asarray(y)),
          tol=0)


def test_multi_block_convs_match_jax_and_reformulate_exactly():
    x, w, f = _inputs(2)
    tx, tw, tf = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(f)
    jx, jw, jf = jnp.asarray(x), jnp.asarray(w), jnp.asarray(f)
    # The minimal-FLOP packed 3x3 == pack(conv(x, w, pad 1)).
    got = tpk.conv_packed_3x3_cells(tpk.pack(tx), tpk.build_packed_conv2x2(tw))
    close(got, jpk.conv_packed_3x3_cells(jpk.pack(jx),
                                         jpk.build_packed_conv2x2(jw)))
    plain = torch.nn.functional.conv2d(tx, tw, padding=1)
    torch.testing.assert_close(got, tpk.pack(plain), rtol=0, atol=1e-4)
    # The up-conv from a packed input, repacked == pack(conv2d_resample(up=2)).
    got = tpk.repack_up(tpk.conv_packed(
        tpk.pack(tx), tpk.build_packed_upconv_packed(tw, tf)))
    close(got, jpk.repack_up(jpk.conv_packed(
        jpk.pack(jx), jpk.build_packed_upconv_packed(jw, jf))))
    ref = tcr.conv2d_resample(tx, tw, f=tf, up=2, padding=1,
                              flip_weight=False)
    torch.testing.assert_close(got, tpk.pack(ref), rtol=0,
                               atol=1e-4 * float(ref.abs().max()))


def _cfgs(tail_blocks=1, fused=True, architecture="skip", packed=True,
          num_fp16_res=0):
    def build(m):
        return m.GeneratorConfig(
            z_dim=32, w_dim=32, img_resolution=64,
            mapping=m.MappingConfig(num_layers=2),
            synthesis=m.SynthesisConfig(
                channel_base=1024, channel_max=32, conv_clamp=256,
                architecture=architecture, packed_last_block=packed,
                packed_tail_blocks=tail_blocks, packed_fused_torgb=fused,
                num_fp16_res=num_fp16_res))
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
    return flat


def _jax_fwd_grads(jcfg, flat, ws, r):
    jparams = jck.flat_to_tree(flat)["synthesis"]

    def loss(p, ws):
        img = jsg.synthesis_apply(jcfg.synthesis, p, ws, noise_mode="const")
        return jnp.sum(img * r), img

    (_, img), (gp, gws) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(ws))
    return np.asarray(img), jck.tree_to_flat(gp), np.asarray(gws)


def _port_fwd_grads(tcfg, flat, ws, r):
    params = tck.flat_to_tree(flat)["synthesis"]
    leaves = tck.tree_to_flat_tensors(params)
    for t in leaves.values():
        t.requires_grad_(True)
    tws = torch.from_numpy(ws).requires_grad_(True)
    img = tsg.synthesis_apply(tcfg.synthesis, params, tws, noise_mode="const")
    (img * torch.from_numpy(r)).sum().backward()
    return (img.detach().numpy(), {k: t.grad for k, t in leaves.items()},
            tws.grad.numpy())


TAILS = [(2, True), (2, False), (3, True), (3, False), (1, False)]


@pytest.mark.parametrize("tail_blocks,fused", TAILS)
def test_packed_tail_matches_jax(tail_blocks, fused, monkeypatch):
    jcfg, tcfg = _cfgs(tail_blocks, fused)
    flat = _weights(tcfg, seed=tail_blocks)
    rng = np.random.RandomState(10 + tail_blocks)
    ws = rng.randn(2, tcfg.num_ws, 32).astype(np.float32)
    r = rng.randn(2, 3, 64, 64).astype(np.float32)
    calls = []
    tail = tsg._packed_tail
    monkeypatch.setattr(tsg, "_packed_tail", lambda cfg, p, t, *a, **k: (
        calls.append([res for res, _ in t]) or tail(cfg, p, t, *a, **k)))
    img, g_leaves, g_ws = _port_fwd_grads(tcfg, flat, ws, r)
    assert calls == [[64, 32, 16][:tail_blocks][::-1]]
    want_img, want_leaves, want_ws = _jax_fwd_grads(jcfg, flat, ws, r)
    np.testing.assert_allclose(img, want_img, rtol=0,
                               atol=TOL * np.abs(want_img).max())
    np.testing.assert_allclose(g_ws, want_ws, rtol=0,
                               atol=GRAD_TOL * np.abs(want_ws).max())
    assert set(g_leaves) == set(want_leaves)
    for k, g in g_leaves.items():
        want = np.asarray(want_leaves[k])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(want).max(),
                                                       1e-12), err_msg=k)
    # An exact reformulation of the unpacked blocks.
    _, plain = _cfgs(packed=False)
    with torch.no_grad():
        ref = tsg.synthesis_apply(plain.synthesis,
                                  tck.flat_to_tree(flat)["synthesis"],
                                  torch.from_numpy(ws))
    np.testing.assert_allclose(img, ref.numpy(), rtol=0,
                               atol=TOL * float(ref.abs().max()))


@pytest.mark.parametrize("tail_blocks", [2, 3])
def test_packed_tail_bf16_and_remat_match_the_plain_tail(tail_blocks):
    """bf16 in the tail blocks (num_fp16_res 3): within a bf16 rounding of
    the unpacked bf16 forward; remat of the tail gives the same gradients
    as no remat."""
    _, tcfg = _cfgs(tail_blocks, num_fp16_res=3)
    _, plain = _cfgs(packed=False, num_fp16_res=3)
    flat = _weights(tcfg, seed=20 + tail_blocks)
    params = tck.flat_to_tree(flat)["synthesis"]
    ws = torch.from_numpy(np.random.RandomState(21).randn(
        2, tcfg.num_ws, 32).astype(np.float32))
    with torch.no_grad():
        a = tsg.synthesis_apply(tcfg.synthesis, params, ws)
        b = tsg.synthesis_apply(plain.synthesis, params, ws)
    rms = float((a - b).square().mean().sqrt() / b.square().mean().sqrt())
    assert rms <= 2 ** -5
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg.synthesis, remat=remat)
        w = ws.clone().requires_grad_(True)
        tsg.synthesis_apply(cfg, params, w).square().sum().backward()
        grads.append(w.grad)
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)


def test_orig_generator_matches_jax():
    """architecture="orig": torgb in the last block only (no skip image),
    run unpacked even with packed_last_block set, as in JAX.

    Without the skip image every gradient reaches the early blocks through
    the whole chain, and on some draws a kink of the activation sits on the
    data: a 1e-6 relative change of ws then moves the port's own b64.conv0
    gradient by ~2%, and neither package can be held to 1e-3 of the other.
    The test first shows that its draw is not such a point (the port's
    gradients move by under 1e-4 of max there)."""
    jcfg, tcfg = _cfgs(architecture="orig")
    flat = _weights(tcfg, seed=30)
    jflat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0), jcfg))
    assert set(flat) == set(jflat)
    assert [k for k in flat if ".torgb." in k and k.endswith(".weight")
            and "affine" not in k] == ["synthesis.b64.torgb.weight"]
    rng = np.random.RandomState(32)
    ws = rng.randn(2, tcfg.num_ws, 32).astype(np.float32)
    r = rng.randn(2, 3, 64, 64).astype(np.float32)
    img, g_leaves, g_ws = _port_fwd_grads(tcfg, flat, ws, r)
    nudged = ws * (1 + 1e-6 * np.random.RandomState(0).randn(*ws.shape))
    _, g_nudged, _ = _port_fwd_grads(tcfg, flat, nudged.astype(np.float32), r)
    for k, g in g_leaves.items():
        assert float((g - g_nudged[k]).abs().max()) <= 1e-4 * max(
            float(g.abs().max()), 1e-12), k
    want_img, want_leaves, want_ws = _jax_fwd_grads(jcfg, flat, ws, r)
    np.testing.assert_allclose(img, want_img, rtol=0,
                               atol=TOL * np.abs(want_img).max())
    np.testing.assert_allclose(g_ws, want_ws, rtol=0,
                               atol=GRAD_TOL * np.abs(want_ws).max())
    for k, g in g_leaves.items():
        want = np.asarray(want_leaves[k])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(want).max(),
                                                       1e-12), err_msg=k)


def test_orig_styles_and_hooks_follow_jax():
    """generator_styles / synthesis_from_styles on an "orig" G, and offsets
    made over ``layer_names()`` (a torgb for every block, as JAX lists
    them): the hooks of the torgbs an "orig" G lacks are never read, in
    either package."""
    from gagan_tpu.params import offsets as joffs
    from gagan_tpu_torch.params import offsets as toffs

    jcfg, tcfg = _cfgs(architecture="orig", packed=False)
    flat = _weights(tcfg, seed=32)
    jp, tp = jck.flat_to_tree(flat)["synthesis"], tck.flat_to_tree(flat)[
        "synthesis"]
    ws = np.random.RandomState(33).randn(2, tcfg.num_ws, 32).astype(np.float32)
    js = jsg.generator_styles(jcfg.synthesis, jp, jnp.asarray(ws))
    ts_ = tsg.generator_styles(tcfg.synthesis, tp, torch.from_numpy(ws))
    n_layers = len(tcfg.synthesis.layer_names())
    assert len(ts_) == len(js) == n_layers - (len(
        tcfg.synthesis.block_resolutions) - 1)
    for a, b in zip(ts_, js):
        close(a, b)
    close(tsg.synthesis_from_styles(tcfg.synthesis, tp, ts_),
          jsg.synthesis_from_styles(jcfg.synthesis, jp, js))

    spec = "additive"
    joff = joffs.init_offsets(jax.random.PRNGKey(1), jcfg.synthesis,
                              joffs.OffsetsSpec.from_string(spec))
    rng = np.random.RandomState(34)
    joff = jax.tree.map(lambda x: jnp.asarray(
        rng.randn(*x.shape).astype(np.float32) * 0.3), joff)
    assert "b32.torgb" in joff                  # listed though absent
    toff = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), joff)
    want = jsg.synthesis_apply(
        jcfg.synthesis, jp, jnp.asarray(ws), noise_mode="const",
        hooks=joffs.make_hooks(joffs.OffsetsSpec.from_string(spec), joff))
    with torch.no_grad():
        got = tsg.synthesis_apply(
            tcfg.synthesis, tp, torch.from_numpy(ws), noise_mode="const",
            hooks=toffs.make_hooks(toffs.OffsetsSpec.from_string(spec), toff))
    close(got, want)


def test_resnet_generator_stays_refused():
    _, tcfg = _cfgs(architecture="resnet")
    with pytest.raises(NotImplementedError, match="'skip' and 'orig'"):
        tsg.synthesis_apply(tcfg.synthesis, {}, torch.zeros(1, tcfg.num_ws,
                                                            32))
