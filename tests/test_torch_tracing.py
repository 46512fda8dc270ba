"""The port's span recorder (gagan_tpu_torch.utils.observability): a span
records only while a profiler records (or ``recording(True)`` holds), as
one named host event of the profiler's trace and one record in memory;
off, it enters no profiler range and keeps nothing.  Then the spans of a
tiny CPU training loop under the profiler."""

import dataclasses
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gagan_tpu_torch.data import ImageFolderDataset
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.train import gan_loss as tgl
from gagan_tpu_torch.train import loop as tloop
from gagan_tpu_torch.train import train_step as tts
from gagan_tpu_torch.utils import observability as tobs

from .test_torch_loop import (_cfgs, _loop_cfg, _train_cfg,  # noqa: F401
                              data_dir)


@pytest.fixture(autouse=True)
def _no_spans():
    tobs.reset_spans()
    yield
    tobs.recording(False)
    tobs.reset_spans()


def _events(prof, name):
    return [e for e in prof.events() if e.name == name]


def test_off_keeps_nothing_and_enters_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span entered a profiler range while off")

    monkeypatch.setattr(tobs, "_HostRange", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    @tobs.traced("fn", device=True)
    def fn(x):
        return x + 1

    with tobs.trace_scope("outer", device=True):
        with tobs.trace_scope("inner"):
            assert fn(1) == 2
    assert tobs.span_records() == [] and tobs.span_totals() == {}


def test_nested_spans_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with tobs.trace_scope("outer", device=True):
                with tobs.trace_scope("inner"):
                    torch.ones(4).sum()
                with tobs.trace_scope("inner"):
                    pass
    recs = tobs.span_records()
    assert [(r.name, r.parent) for r in recs] == [
        ("inner", "outer"), ("inner", "outer"), ("outer", None)] * 2
    assert all(r.end_ns >= r.start_ns for r in recs)
    totals = tobs.span_totals()
    assert {k: v["count"] for k, v in totals.items()} == {"outer": 2,
                                                          "inner": 4}
    assert totals["outer"]["host_ms"] >= totals["inner"]["host_ms"] / 2
    # One host event of the trace a span, on the CPU with no device time.
    assert len(_events(prof, "outer")) == 2
    assert len(_events(prof, "inner")) == 4
    assert all(v["device_ms"] is None for v in totals.values())
    tobs.reset_spans()
    assert tobs.span_totals() == {}


def test_span_entered_off_records_nothing():
    """Recording is decided on entry: a span entered before the profiler
    started records nothing; one entered while it records is kept even if
    the profiler stops before the span ends."""
    prof = profile(activities=[ProfilerActivity.CPU])
    before = tobs.trace_scope("before")
    before.__enter__()
    prof.start()
    before.__exit__(None, None, None)
    with tobs.trace_scope("during"):
        prof.stop()
    assert [r.name for r in tobs.span_records()] == ["during"]
    assert not _events(prof, "before")


def test_recording_without_a_profiler():
    assert tobs.recording(True) is False
    with tobs.trace_scope("forced"):
        pass
    assert tobs.recording(False) is True
    with tobs.trace_scope("forced"):
        pass
    assert tobs.span_totals()["forced"]["count"] == 1


@pytest.mark.parametrize("simultaneous", [False, True])
def test_loop_spans_under_the_profiler(simultaneous, data_dir,  # noqa: F811
                                       tmp_path, monkeypatch):
    """Two batches of the tiny loop: one ``loop.next_batch``, one main
    phase span and one ``host_read.stats`` read a batch."""
    # TensorBoard off (its import loads TensorFlow here, seconds of it).
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tg, td = _cfgs(tsg)
    train_cfg = dataclasses.replace(_train_cfg(tts, tgl),
                                    simultaneous_main=simultaneous)
    loop_cfg = _loop_cfg(tloop, str(tmp_path / "run"), total_kimg=0.008,
                         image_snapshot_ticks=None,
                         network_snapshot_ticks=None)
    with profile(activities=[ProfilerActivity.CPU]):
        state = tloop.training_loop(loop_cfg, train_cfg, tg, td,
                                    ImageFolderDataset(data_dir),
                                    device="cpu")
    batches = state.cur_nimg // train_cfg.batch_size
    assert batches == 2
    totals = tobs.span_totals()
    main = ["step.gd_main"] if simultaneous else ["step.g_main",
                                                  "step.d_main"]
    for name in ["loop.next_batch", "loop.step", "host_read.stats"] + main:
        assert totals[name]["count"] == batches, name
    assert ("step.g_main" in totals) is not simultaneous
    parents = {r.name: r.parent for r in tobs.span_records()}
    assert parents[main[0]] == "loop.step"
    assert parents["G.synthesis"] in main
    assert totals["loader.read_batch"]["count"] >= batches
