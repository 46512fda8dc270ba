"""The port's six ReStyle encoders (gagan_tpu_torch/inversion/restyle.py)
against the JAX package's, on weights drawn here from a numpy seed in the
JAX init's tree (convolutions scaled 1/sqrt(fan-in), batch norms with
non-trivial running statistics) and crossed as numpy with its flat keys;
the iterative protocol and the converter are in test_torch_restyle_net.py,
which shares the weights and the reference-layout checkpoint made here.

The encoders run at a 64^2 input with ``stylegan_size=256`` (14 heads):
every head level of the FPN variants and every ResNet34 block does real
work.  Tolerance: 2e-4 of max|JAX| (the suite's forward tolerance, as
tests/test_torch_encoders.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.inversion import restyle as jrs
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch.inversion import restyle as trs
from gagan_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

SIZE = 256


def _cfgs(encoder_type):
    return (jrs.RestyleEncoderConfig(encoder_type=encoder_type,
                                     stylegan_size=SIZE),
            trs.RestyleEncoderConfig(encoder_type=encoder_type,
                                     stylegan_size=SIZE))


def encoder_flat(encoder_type, seed=0, size=SIZE):
    """Seeded weights in the tree of the JAX init of ``encoder_type``.  The
    ~130M convolution weights are windows of one pool of 2^22 normal draws
    at seeded offsets (drawing each would dominate the file's time)."""
    jcfg = jrs.RestyleEncoderConfig(encoder_type=encoder_type,
                                    stylegan_size=size)
    shapes = jax.eval_shape(lambda: jrs.init_restyle_encoder(
        jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal(1 << 22, np.float32)

    def normal(shape):
        n = int(np.prod(shape))
        start = int(rng.integers(0, pool.size))
        return np.resize(np.roll(pool, -start), n).reshape(shape)

    flat = {}
    for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        k = ".".join(str(p.key) for p in path)
        shape, leaf = tuple(v.shape), k.rsplit(".", 1)[1]
        if leaf == "running_var":
            flat[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif leaf in ("running_mean", "bias"):
            flat[k] = rng.standard_normal(shape, np.float32) * 0.1
        elif len(shape) == 4:
            flat[k] = normal(shape) * np.float32(np.sqrt(
                1.0 / np.prod(shape[1:])))
        elif ".linear." in k:
            flat[k] = normal(shape)
        elif (k.startswith(("relu.", "input_layer.2."))
              or ".res_layer.2." in k):                       # PReLU
            flat[k] = rng.uniform(0.1, 0.4, shape).astype(np.float32)
        else:                                                 # BN scales
            flat[k] = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    return flat


def _close(got, want, tol=2e-4):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_init_matches_jax_tree():
    """The init's tree at stylegan_size 32 (8 heads: each FPN level)."""
    for t in trs.ENCODER_TYPES:
        tcfg = trs.RestyleEncoderConfig(encoder_type=t, stylegan_size=32)
        got = {k: tuple(v.shape) for k, v in tck.tree_to_flat_tensors(
            trs.init_restyle_encoder(torch.Generator().manual_seed(0),
                                     tcfg)).items()}
        want = {k: v.shape for k, v in encoder_flat(t, size=32).items()}
        assert got == want, t
    assert _cfgs("BackboneEncoder")[1].style_count == 14
    assert trs.resnet34_blocks() == jrs.resnet34_blocks()
    assert trs.RESNET_TAPS == jrs.RESNET_TAPS


@pytest.mark.parametrize("encoder_type,stage", [
    ("BackboneEncoder", None), ("ResNetBackboneEncoder", None),
    ("ProgressiveBackboneEncoder", None), ("ProgressiveBackboneEncoder", 2),
    ("ResNetProgressiveBackboneEncoder", None),
    ("ResNetProgressiveBackboneEncoder", 5),
    ("GradualStyleEncoder", None), ("ResNetGradualStyleEncoder", None)])
def test_restyle_encode_matches_jax(encoder_type, stage):
    jcfg, tcfg = _cfgs(encoder_type)
    flat = encoder_flat(encoder_type, seed=len(encoder_type))
    x = np.random.RandomState(1).uniform(-1, 1, (2, 6, 64, 64)).astype(
        np.float32)
    want = jrs.restyle_encode(jcfg, jck.flat_to_tree(flat), jnp.asarray(x),
                              stage=stage)
    got = trs.restyle_encode(tcfg, tck.flat_to_tree(flat),
                             torch.from_numpy(x), stage=stage)
    assert tuple(got.shape) == (2, 14, 512)
    _close(got, want)
    if stage is not None:        # the heads past the stage repeat w0
        g = got.numpy()
        assert np.array_equal(g[:, stage + 1:], np.broadcast_to(
            g[:, :1], g[:, stage + 1:].shape))


def test_adaptive_avg_pool_matches_torch():
    x = np.random.RandomState(1).randn(2, 3, 64, 64).astype(np.float32)
    want = torch.nn.AdaptiveAvgPool2d((16, 16))(torch.from_numpy(x))
    got = trs.adaptive_avg_pool(torch.from_numpy(x), 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert trs.adaptive_avg_pool(torch.from_numpy(x), 64) is not None
    with pytest.raises(AssertionError):
        trs.adaptive_avg_pool(torch.from_numpy(x), 48)


def restyle_checkpoint(encoder_type="BackboneEncoder", seed=0, size=16,
                       flat_avg=True):
    """A ReStyle checkpoint in the reference's torch layout: ``encoder.*``
    (with BN ``num_batches_tracked``), a rosinality ``decoder.*`` of
    ``size`` with an 8-layer mapping, opts and latent_avg."""
    from .test_torch_convert import _rosinality_sd

    sd = {f"encoder.{k}": torch.from_numpy(v)
          for k, v in encoder_flat(encoder_type, seed, size).items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    sd.update({f"decoder.{k}": torch.from_numpy(v) for k, v in
               _rosinality_sd(seed, size=size, n_mlp=8).items()})
    n = 2 * int(np.log2(size)) - 2
    avg = np.random.RandomState(seed).randn(*((512,) if flat_avg else
                                              (n, 512))).astype(np.float32)
    return {"state_dict": sd, "latent_avg": torch.from_numpy(avg),
            "opts": {"encoder_type": encoder_type, "output_size": size,
                     "input_nc": 6, "n_iters_per_batch": 5}}



def test_reference_fault_fpn_upsample_is_not_align_corners():
    """The FPN heads' ``_upsample_add`` resizes with ``jax.image.resize``
    bilinear, half-pixel centred (gagan_tpu/inversion/encoders.py:123-128);
    the reference's helper interpolates with ``align_corners=True``, so the
    16 -> 32 -> 64 maps of the GradualStyle encoders differ from the
    reference's away from the centre (tests/test_restyle.py loosens its FPN
    parity to 5e-2 for it).  The port reproduces the JAX package."""
    from gagan_tpu.inversion import encoders as jenc
    from gagan_tpu_torch.inversion import encoders as tenc

    x = np.random.RandomState(8).randn(1, 4, 16, 16).astype(np.float32)
    y = np.zeros((1, 4, 32, 32), np.float32)
    want = np.asarray(jenc._upsample_add(jnp.asarray(x), jnp.asarray(y)))
    got = tenc._upsample_add(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    _close(got, want)
    reference = torch.nn.functional.interpolate(
        torch.from_numpy(x), size=(32, 32), mode="bilinear",
        align_corners=True).numpy()
    assert np.abs(reference - want).max() > 0.1
