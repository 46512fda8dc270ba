"""The port's DiFa trainer (gagan_tpu_torch/train/adaptation.py,
``im2im_difa``) with the SCC loss against the JAX package's, on the tiny
setup and to the tolerances of tests/test_torch_im2im.py.

The SCC loss runs e4e (the weights of tests/test_torch_encoders.py) on
both halves at 64^2 instead of the reference's 256^2 (the port's
``E4E_SIZE`` and the size the JAX step asks ``resize2d`` for, both
patched), with a window of 1 so that the loss is non-zero at step 2.
"""

import types

import numpy as np
import torch

from gagan_tpu.train import adaptation as jad
from gagan_tpu_torch.train import adaptation as tad
from .test_torch_encoders import encoder_flat
from .test_torch_im2im import _steps_match, _trainers, setup  # noqa: F401

torch.set_num_threads(2)

E4E_TEST_SIZE = 64


def test_im2im_difa_steps_and_scc_state_match_jax(setup, monkeypatch):
    """DiFa: direction and difa_local (the style image's CLIP tokens at
    layer 1 against both halves'), and the SCC loss on e4e latents of both
    halves; its window after the steps."""
    monkeypatch.setattr(tad, "E4E_SIZE", E4E_TEST_SIZE)
    resize = jad.ops_resize.resize2d

    def resize_e4e(x, out_hw, method="bicubic", **kw):
        if tuple(out_hw) == (256, 256):        # the step's e4e input
            out_hw = (E4E_TEST_SIZE, E4E_TEST_SIZE)
        return resize(x, out_hw, method, **kw)

    monkeypatch.setattr(jad, "ops_resize",
                        types.SimpleNamespace(resize2d=resize_e4e))
    jtr, ttr = _trainers(
        setup, "im2im_difa", ("direction", "difa_local"), (1.0, 1.0),
        extra={"e4e": encoder_flat(3)}, clip_layer=1,
        scc=dict(weight=6.0, num_keep_first=2, sliding_window_size=1))
    assert ttr.scc_state.source_set.shape == (1, 2 * 512)
    got = _steps_match(jtr, ttr)
    assert got["difa_psp_loss"] > 0 and "difa_local_ViT-B-32" in got
    js, ts = jtr.scc_state, ttr.scc_state
    assert int(ts.count) == int(js.count) == 1
    assert int(ts.pos) == int(js.pos) == 0
    for name in ("source_set", "target_set"):
        want = np.asarray(getattr(js, name))
        np.testing.assert_allclose(getattr(ts, name).numpy(), want, rtol=0,
                                   atol=2e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_difa_e4e_size_is_the_references():
    assert tad.E4E_SIZE == 256
