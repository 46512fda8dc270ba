"""Train-state checkpoints of the port (``utils/checkpoint.py``:
``save_train_state``, ``load_train_state``, ``latest_step``) on the CPU.

The JAX package writes orbax checkpoints, which torch cannot read, so the
port keeps JAX's layout (``ckpt_dir/step_NNNNNNNN``) in a format of its
own; what is held is the round trip: every leaf bit-equal, restored onto
the devices and dtypes of the state it is given, and one train step from
the restored state equal to one from the original under the same draws.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from gagan_tpu.utils import checkpoint as jck
from gagan_tpu_torch import entry
from gagan_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)


def _assert_bit_equal(a, b):
    la, lb = tck.train_state_leaves(a), tck.train_state_leaves(b)
    assert set(la) == set(lb)
    for k, v in la.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == lb[k].dtype and v.device == lb[k].device, k
            assert torch.equal(v, lb[k]), k
        else:
            assert v == lb[k], k


@pytest.fixture(scope="module")
def stepped():
    """A few-shot train state (G, D, G_ema, both Adam states, ADA, the
    offsets with their EMA and Adam state) after one "both" step, and the
    steps and inputs, at 32^2."""
    steps, state, (real, _, z, _, key) = entry.fewshot_entry(
        "cpu", batch=4, img_resolution=32, channel_base=256, ada_p=0.3)
    state, _ = steps["both"](state, real, None, z, None, key)
    return steps, state, (real, z, key)


def test_round_trip_is_bit_equal_and_steps_alike(stepped, tmp_path):
    steps, state, (real, z, key) = stepped
    assert state.g_opt_state.count > 0 and state.offsets is not None
    tck.save_train_state(str(tmp_path), 7, state)
    assert sorted(os.listdir(tmp_path)) == ["step_00000007"]
    like = copy.deepcopy(state)
    restored = tck.load_train_state(str(tmp_path), 7, like)
    _assert_bit_equal(restored, state)
    a, ma = steps["greg"](copy.deepcopy(state), real, None, z, None,
                          key.fold_in(1))
    b, mb = steps["greg"](restored, real, None, z, None, key.fold_in(1))
    _assert_bit_equal(b, a)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_restore_follows_the_like_states_dtypes(stepped, tmp_path):
    _, state, _ = stepped
    tck.save_train_state(str(tmp_path), 1, state)
    like = copy.deepcopy(state)
    like.pl_mean = like.pl_mean.double()
    restored = tck.load_train_state(str(tmp_path), 1, like)
    assert restored.pl_mean.dtype == torch.float64
    assert float(restored.pl_mean) == float(state.pl_mean)


def test_missing_extra_and_misshapen_leaves_raise(stepped, tmp_path):
    _, state, _ = stepped
    tck.save_train_state(str(tmp_path), 2, state)
    like = copy.deepcopy(state)
    like.g_opt_state.mu["extra.leaf"] = torch.zeros(1)
    with pytest.raises(KeyError, match="missing.*extra.leaf"):
        tck.load_train_state(str(tmp_path), 2, like)
    like = copy.deepcopy(state)
    del like.d_opt_state.nu[next(iter(like.d_opt_state.nu))]
    with pytest.raises(KeyError, match="unexpected"):
        tck.load_train_state(str(tmp_path), 2, like)
    like = copy.deepcopy(state)
    like.ada_p = torch.zeros(2)
    with pytest.raises(ValueError, match="ada_p"):
        tck.load_train_state(str(tmp_path), 2, like)


def test_latest_step_follows_jax(tmp_path):
    assert tck.latest_step(str(tmp_path / "none")) is None
    assert jck.latest_step(str(tmp_path / "none")) is None
    for step in (3, 12, 5):
        tck.save_train_state(str(tmp_path), step, {"x": torch.ones(2) * step})
    assert tck.latest_step(str(tmp_path)) == jck.latest_step(
        str(tmp_path)) == 12
    # Saving a step again replaces it.
    tck.save_train_state(str(tmp_path), 12, {"x": torch.zeros(2)})
    got = tck.load_train_state(str(tmp_path), 12, {"x": torch.ones(2)})
    assert torch.equal(got["x"], torch.zeros(2))
    assert not [d for d in os.listdir(tmp_path) if not d.startswith("step_")]
