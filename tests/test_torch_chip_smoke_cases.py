"""The kernel cases of chip_smoke.py, checked on the CPU: each lies inside
the fused kernel's predicate, together they reach the kernel's edges, and
the plain version runs at each case's shape (shrunk to one sample)."""

import pytest
import torch

import chip_smoke as cs
from gagan_tpu_torch.ops import fused_modconv as fmc

torch.set_num_threads(2)

# The bf16 kernel's tile (csrc/fused_modconv.cu, namespace tc): 4 x 64
# pixels, 64-channel chunks of C_in, 128 output channels.
TILE_ROWS, TILE_COLS, CHANNEL_CHUNK, C_OUT_TILE = 4, 64, 64, 128

CASES = pytest.mark.parametrize("case", cs.KERNEL_CASES,
                                ids=[c.label for c in cs.KERNEL_CASES])


@CASES
def test_case_inside_predicate(case):
    assert fmc.supported_shape((case.n, case.c_in, case.h, case.w),
                               (case.c_out, case.c_in, 3, 3))


def test_cases_cover_the_kernel_edges():
    bf16 = [c for c in cs.KERNEL_CASES if c.dtype == torch.bfloat16]
    assert any(c.h % TILE_ROWS for c in bf16)                # ragged H
    assert any(c.w % TILE_COLS for c in bf16)                # ragged W
    assert any(c.c_in % CHANNEL_CHUNK for c in bf16)         # partial chunk
    assert any(c.c_out > 2 * C_OUT_TILE for c in bf16)       # 3 C_out tiles
    assert any(c.n == 1 for c in bf16)
    assert any(not c.noise and c.clamp is None and not c.demodulate
               for c in bf16)
    assert any(c.dtype == torch.float32 for c in cs.KERNEL_CASES)
    on_path = [(c.c_in, c.h) for c in cs.KERNEL_CASES if c.on_path]
    assert on_path == [(256, 128), (128, 256)]               # b128, b256


@CASES
def test_plain_version_runs_on_cpu(case):
    case = case._replace(n=1)
    a = cs.level_inputs(case, seed=0, device="cpu")
    y = fmc.fused_modconv3x3_ref(a["x"], a["w"], a["styles"], a["dcoefs"],
                                 a["noise"], a["bias"], clamp=case.clamp)
    assert y.dtype == case.dtype
    assert tuple(y.shape) == (1, case.c_out, case.h, case.w)
    assert bool(torch.isfinite(y.float()).all())
