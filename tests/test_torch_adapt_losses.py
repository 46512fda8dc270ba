"""The port's adaptation losses (gagan_tpu_torch.train.adapt_losses) against
the JAX package's: every registered loss on the same numpy inputs, and
direct_loss with the SCC window over several updates.  Tolerance: the
suite's fp32 forward 2e-4 relative (and 1e-6 absolute near 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.train import adapt_losses as jal
from gagan_tpu_torch.train import adapt_losses as tal

torch.set_num_threads(2)


def _inputs(seed=0, n=4, d=16, templates=None):
    rng = np.random.RandomState(seed)

    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)

    emb_shape = templates + (d,) if templates else (n, d)
    return {"trg_encoded": arr(n, d), "src_encoded": arr(n, d),
            "trg_domain_emb": arr(*emb_shape), "src_domain_emb": arr(*emb_shape),
            "trg_trainable_emb": arr(n, d), "trg_emb": arr(1, d),
            "trg_tokens": arr(n, 6, d), "trg_tokens_style": arr(5, d)}


def _both(fn_name, registry, data):
    want = getattr(jal, registry)[fn_name](
        jax.tree.map(jnp.asarray, data))
    got = getattr(tal, registry)[fn_name](
        {k: ([torch.from_numpy(x) for x in v] if isinstance(v, list)
             else torch.from_numpy(v)) for k, v in data.items()})
    return float(got), float(want)


# (loss, template axis): direction takes [1, T, D] domain embeddings (the
# adapt CLI's), tt_direction [N, T, D].
CLIP_CASES = [(name, None) for name in sorted(jal.clip_losses)] + [
    ("direction", (1, 7)), ("tt_direction", (4, 7))]


@pytest.mark.parametrize("name,templates", CLIP_CASES)
def test_clip_losses_match_jax(name, templates):
    data = _inputs(templates=templates)
    got, want = _both(name, "clip_losses", data)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def _rec_data(seed=1):
    rng = np.random.RandomState(seed)
    keys = ("style_inverted_B_256x256", "style_image_256x256",
            "style_inverted_B_1024x1024", "style_image_1024x1024")
    data = {k: rng.randn(2, 3, 8, 8).astype(np.float32) for k in keys}
    data["style_inverted_B_lpips"] = rng.randn(2, 5).astype(np.float32)
    data["style_image_lpips"] = rng.randn(2, 5).astype(np.float32)
    data["disc_feats_fake"] = [rng.randn(4, 3, 2).astype(np.float32),
                               rng.randn(4, 5).astype(np.float32)]
    data["disc_feats_real"] = [rng.randn(2, 3, 2).astype(np.float32),
                               rng.randn(1, 5).astype(np.float32)]
    return data


@pytest.mark.parametrize("name", sorted(jal.rec_losses))
def test_rec_losses_match_jax(name):
    got, want = _both(name, "rec_losses", _rec_data())
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def _offsets(seed=2):
    rng = np.random.RandomState(seed)
    return {"b8.conv0": {"offset": rng.randn(1, 4).astype(np.float32),
                         "gamma": rng.randn(1, 4).astype(np.float32),
                         "beta": rng.randn(1, 4).astype(np.float32)},
            "b8.torgb": {"offset": rng.randn(1, 6).astype(np.float32),
                         "gamma": rng.randn(1, 6).astype(np.float32),
                         "beta": rng.randn(1, 6).astype(np.float32),
                         "affine": {"x": np.zeros(3, np.float32)}}}


@pytest.mark.parametrize("name", sorted(jal.reg_losses))
def test_reg_losses_match_jax(name):
    off = _offsets()
    want = jal.reg_losses[name](jax.tree.map(jnp.asarray, off))
    got = tal.reg_losses[name]({k: {a: (torch.from_numpy(b) if not
                                        isinstance(b, dict) else b)
                                    for a, b in v.items()}
                                for k, v in off.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)


def test_direct_loss_with_scc_window_matches_jax():
    """direct_loss over 12 updates of an SCC window of 4 (it fills, wraps
    and the regular weight ramps up), with two towers' clip data and the
    offsets regularizer."""
    scc_cfg = dict(weight=6.0, num_keep_first=2, sliding_window_size=4)
    jcfg = jal.DirectLossConfig(loss_funcs=("direction", "offsets_l2"),
                                loss_coefs=(1.0, 0.1),
                                scc=jal.SCCConfig(**scc_cfg))
    tcfg = tal.DirectLossConfig(loss_funcs=("direction", "offsets_l2"),
                                loss_coefs=(1.0, 0.1),
                                scc=tal.SCCConfig(**scc_cfg))
    jstate = jal.init_scc_state(2 * 8, window=4)
    tstate = tal.init_scc_state(2 * 8, window=4)
    off = {"b8.conv0": {"offset": np.random.RandomState(3).randn(1, 4).astype(
        np.float32)}}
    for it in range(12):
        rng = np.random.RandomState(10 + it)
        clip = {name: {k: v for k, v in _inputs(seed=20 + it + i).items()
                       if k.endswith(("_encoded", "_domain_emb"))}
                for i, name in enumerate(("ViT-B/32", "ViT-B/16"))}
        inv = {"src_latents": rng.randn(3, 32).astype(np.float32),
               "trg_latents": rng.randn(3, 32).astype(np.float32)}
        cur = 2.0 + 2 * it
        jl, jstate = jal.direct_loss(jcfg, {
            "clip_data": jax.tree.map(jnp.asarray, clip),
            "offsets": jax.tree.map(jnp.asarray, off),
            "inv_data": {**jax.tree.map(jnp.asarray, inv),
                         "iters": jnp.float32(cur), "total_iters": 20}},
            jstate)
        tl, tstate = tal.direct_loss(tcfg, {
            "clip_data": {n: {k: torch.from_numpy(v) for k, v in cb.items()}
                          for n, cb in clip.items()},
            "offsets": {k: {a: torch.from_numpy(b) for a, b in v.items()}
                        for k, v in off.items()},
            "inv_data": {**{k: torch.from_numpy(v) for k, v in inv.items()},
                         "iters": cur, "total_iters": 20}}, tstate)
        assert sorted(tl) == sorted(jl) == sorted([
            "direction_ViT-B-32", "direction_ViT-B-16", "offsets_l2",
            "difa_psp_loss", "total"])
        for k in jl:
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=2e-4,
                                       atol=1e-6, err_msg=f"{k} at {it}")
        assert int(tstate.count) == int(jstate.count) == min(it + 1, 4)
        assert int(tstate.pos) == int(jstate.pos)
        np.testing.assert_allclose(tstate.source_set.numpy(),
                                   np.asarray(jstate.source_set), atol=1e-6)
    assert float(tl["difa_psp_loss"]) > 0


def test_direction_gradient_is_finite_at_a_zero_edit():
    """With zero offsets the image edit is exactly 0: the loss and its
    gradient stay finite, and equal JAX's."""
    data = _inputs(templates=(1, 7))
    data["trg_encoded"] = data["src_encoded"].copy()
    trg = torch.from_numpy(data["trg_encoded"]).requires_grad_(True)
    cb = {k: torch.from_numpy(v) for k, v in data.items()}
    cb["trg_encoded"] = trg
    loss = tal.direction_loss(cb)
    (grad,) = torch.autograd.grad(loss, [trg])
    assert float(loss) == pytest.approx(1.0)
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0
    want = jax.grad(lambda t: jal.direction_loss(
        {**jax.tree.map(jnp.asarray, data), "trg_encoded": t}))(
        jnp.asarray(data["trg_encoded"]))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3 * np.abs(np.asarray(want)).max())
