"""The port's CLIP towers and resize (gagan_tpu_torch.clip.model,
ops/resize.py) against the JAX package's on the same weights (a 2-layer
tower of width 64, patch 8, at 32^2; JAX init, bridged as numpy).

Tolerances: fp32, 1e-5 of max|.| for the resize and preprocessing (the
same matmuls; 4e-5 against ``jax.image.resize``) and 2e-4 for the towers (the suite's forward tolerance);
bf16, 2^-5 of max|.| for the embeddings and taps (bf16 rounds at 2^-9
relative, at somewhat different places in the two: F.linear adds the bias
before rounding, JAX after; a dozen roundings in series).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.clip import model as jclip
from gagan_tpu.clip.tokenizer import SimpleTokenizer as JTok
from gagan_tpu.clip.tokenizer import tokenize as jtokenize
from gagan_tpu.ops import resize as jresize
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.clip import model as tclip
from gagan_tpu_torch.ops import resize as tresize
from gagan_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)


def _cfgs():
    kw = dict(embed_dim=32, image_resolution=32, vision_layers=2,
              vision_width=64, vision_patch_size=8, transformer_width=32,
              transformer_heads=4, transformer_layers=2,
              vision_heads_override=4)
    return jclip.CLIPConfig(**kw), tclip.CLIPConfig(**kw)


@pytest.fixture(scope="module")
def flat():
    jcfg, _ = _cfgs()
    return jck.tree_to_flat(jclip.init_clip(jax.random.PRNGKey(1), jcfg))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("src,dst,method", [(1024, 224, "bicubic"),
                                            (64, 32, "bicubic"),
                                            (32, 48, "bilinear"),
                                            (17, 17, "bicubic")])
def test_resize_matches_jax(src, dst, method):
    np.testing.assert_array_equal(tresize.weight_matrix(src, dst, method),
                                  jresize.weight_matrix(src, dst, method))
    x = np.random.RandomState(0).rand(2, 3, src, min(src, 64)).astype(
        np.float32)
    out = (dst, min(dst, 40))
    want = jresize.resize2d(jnp.asarray(x), out, method, precision="highest")
    got = tresize.resize2d(torch.from_numpy(x), out, method)
    _close(got.numpy(), want, 1e-5)
    # The same as jax.image.resize (antialiased), which sums the up to 1024
    # taps in another order.
    ref = jax.image.resize(jnp.asarray(x), x.shape[:2] + out, method)
    _close(got.numpy(), ref, 4e-5)


def test_preprocess_matches_jax():
    x = np.random.RandomState(1).uniform(0, 255, (2, 3, 64, 64)).astype(
        np.float32)
    want = jclip.preprocess_image(jnp.asarray(x), 32)
    got = tclip.preprocess_image(torch.from_numpy(x), 32)
    _close(got.numpy(), want, 1e-5)
    u8 = x.astype(np.uint8)
    _close(tclip.preprocess_image(torch.from_numpy(u8), 32).numpy(),
           jclip.preprocess_image(jnp.asarray(u8), 32), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_image_matches_jax(flat, dtype):
    jcfg, tcfg = _cfgs()
    x = np.random.RandomState(2).uniform(0, 255, (3, 3, 64, 64)).astype(
        np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    td = torch.bfloat16 if dtype == "bfloat16" else None
    want, want_hid = jclip.encode_image(jcfg, jck.flat_to_tree(flat),
                                        jnp.asarray(x), return_hidden=(0, 1),
                                        dtype=jd)
    got, got_hid = tclip.encode_image(tcfg, tck.flat_to_tree(flat),
                                      torch.from_numpy(x),
                                      return_hidden=(0, 1), dtype=td)
    rel = 2e-4 if dtype == "float32" else 2 ** -5
    assert got.dtype == torch.float32
    _close(got.numpy(), want, rel)
    assert sorted(got_hid) == [0, 1]
    for i in (0, 1):
        assert tuple(got_hid[i].shape) == (3, 16, 64)      # CLS dropped
        assert got_hid[i].dtype == torch.float32
        _close(got_hid[i].numpy(), want_hid[i], rel)
    # Unnormalized, without preprocessing.
    xp = np.random.RandomState(3).randn(2, 3, 32, 32).astype(np.float32)
    want, _ = jclip.encode_image(jcfg, jck.flat_to_tree(flat), jnp.asarray(xp),
                                 normalize=False, preprocess=False)
    got, _ = tclip.encode_image(tcfg, tck.flat_to_tree(flat),
                                torch.from_numpy(xp), normalize=False,
                                preprocess=False)
    _close(got.numpy(), want, 2e-4)


def test_patch_embedding_equals_strided_conv(flat):
    """The extract + matmul patch embedding is the stride-p conv."""
    _, tcfg = _cfgs()
    w = torch.from_numpy(flat["visual.conv1.weight"])
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 32, 32).astype(
        np.float32))
    conv = torch.nn.functional.conv2d(x, w, stride=8).flatten(2).transpose(1, 2)
    n, p, g = 2, 8, 4
    xp = x.reshape(n, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(
        n, g * g, -1)
    torch.testing.assert_close(xp @ w.reshape(64, -1).t(), conv, rtol=0,
                               atol=1e-5)


def test_encode_text_matches_jax(flat):
    jcfg, tcfg = _cfgs()
    tok = JTok()
    ids = jtokenize(["a photo of a Photo.", "an anime drawing", "x"], tok,
                    context_length=jcfg.context_length)
    want = jclip.encode_text(jcfg, jck.flat_to_tree(flat), jnp.asarray(ids))
    got = tclip.encode_text(tcfg, tck.flat_to_tree(flat), torch.from_numpy(ids))
    _close(got.numpy(), want, 2e-4)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               rtol=1e-5)


def test_init_clip_has_the_jax_keys_and_shapes(flat):
    _, tcfg = _cfgs()
    got = tck.tree_to_flat(tclip.init_clip(torch.Generator().manual_seed(0),
                                           tcfg))
    assert sorted(got) == sorted(flat)
    for k in flat:
        assert got[k].shape == flat[k].shape and got[k].dtype == np.float32, k
