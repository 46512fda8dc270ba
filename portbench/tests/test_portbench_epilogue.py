"""The reader of ``epilogue_roofline.img``: the program's byte tally of the
synthesis epilogue kernel at the card's HBM bandwidth over the kernel's
device time in the trace; nothing without the tally, without the kernel in
the trace, or in a program without the kernel's module."""

import builtins
import os

import pytest

from portbench import harness

NAME = "epilogue_roofline.img"
KERNEL = ("void (anonymous namespace)::synthesis_epilogue_kernel<true, 8>"
          "((anonymous namespace)::Params)")


def _read(kernel_s):
    cell = harness.Cell("c", 1, "cfg", {}, "t", {}, [], [], harness.HERE)
    mod = harness.load_module(os.path.join(cell.home, "layers", NAME + ".py"),
                              "portbench_layer_epilogue_roofline_img")
    return mod.read(harness.Reading(
        harness.TraceReading(8.0, 7.0, kernel_s, {}, 0, []), {"steps": 4},
        0))


@pytest.fixture
def tally(monkeypatch):
    from gagan_tpu_torch.ops import synthesis_epilogue as se

    def set_bytes(n):
        monkeypatch.setattr(se.synthesis_epilogue, "traced_bytes", n)
    return set_bytes


def test_reads_the_tally_over_the_kernel_time(tally):
    tally(int(harness.PEAK_HBM * 0.4))        # 0.4 s at the HBM peak
    assert _read({KERNEL: 0.5, "other_kernel": 3.0}) == pytest.approx(80.0)


@pytest.mark.parametrize("case", ["no tally", "no kernel", "no module"])
def test_reads_nothing_without_its_inputs(case, tally, monkeypatch):
    tally(0 if case == "no tally" else 10 ** 9)
    kernels = {"other_kernel": 1.0} if case == "no kernel" else {KERNEL: 1.0}
    if case == "no module":
        real = builtins.__import__

        def refuse(name, *args, **kwargs):
            if "synthesis_epilogue" in name or any(
                    "synthesis_epilogue" in str(a) for a in args[2:3]):
                raise ImportError(name)
            return real(name, *args, **kwargs)
        monkeypatch.setattr(builtins, "__import__", refuse)
    assert _read(kernels) is None
