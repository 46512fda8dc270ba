"""The per-layer readers of the program's spans (``portbench/spans.py``):
each gives a finite number from the spans it reads, and nothing where the
program recorded none (an untraced run, or a program without the span
recorder)."""

import json
import math
import os

import pytest

from portbench import harness, spans
from tests_root import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
READERS = sorted(m["name"] for m in BENCH["per_layer"]
                 if m["source"] == "program_counter"
                 and m["name"] != "peak_mem_gib.train")


def _t(count, host_ms, device_ms=None):
    return {"count": count, "host_ms": host_ms, "device_ms": device_ms}


TOTALS = {
    "loop.next_batch": _t(4, 2.0), "loop.step": _t(4, 900.0, 1800.0),
    "step.gd_main": _t(4, 400.0, 1200.0), "step.g_reg": _t(1, 90.0, 300.0),
    "step.d_reg": _t(1, 40.0, 200.0), "augment": _t(16, 30.0, 160.0),
    "host_read.stats": _t(4, 8.0), "host_read.warp": _t(16, 12.0),
    "adapt.step": _t(4, 440.0, 500.0), "host_read.adapt_losses": _t(1, 1.0),
    "clip.encode_image": _t(4, 20.0, 60.0), "G.apply": _t(4, 600.0, 590.0),
}


def _read(name, steps=4, window_s=2.0):
    cell = harness.Cell("c", 1, "cfg", {}, "t", {}, [], [], harness.HERE)
    mod = harness.load_module(os.path.join(cell.home, "layers", name + ".py"),
                              "portbench_layer_" + name.replace(".", "_"))
    return mod.read(harness.Reading(
        harness.TraceReading(window_s, 1.0, {}, {}, 0, []),
        {"steps": steps}, 0))


def test_every_span_metric_has_a_reader():
    assert len(READERS) == 11
    for name in READERS:
        assert os.path.isfile(os.path.join(harness.HERE, "layers",
                                           name + ".py"))


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_its_spans(name, monkeypatch):
    monkeypatch.setattr(spans, "totals", lambda: dict(TOTALS))
    value = _read(name)
    assert value is not None and math.isfinite(value) and value >= 0, value


@pytest.mark.parametrize("name", READERS)
def test_reader_without_spans_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(spans, "totals", lambda: {})
    assert _read(name) is None


def test_readers_arithmetic(monkeypatch):
    monkeypatch.setattr(spans, "totals", lambda: dict(TOTALS))
    assert _read("loader_wait_ms.train") == 0.5
    assert _read("host_syncs_per_step.train") == 5.25      # 21 reads / 4
    assert _read("sync_wait_ms.train") == 5.25
    assert _read("main_ms.train") == 300.0
    assert _read("greg_ms.train") == 300.0
    assert _read("augment_pct.train") == 8.0               # 160 ms of 2 s
    assert _read("clip_pct.adapt") == 3.0
    assert _read("issue_ms.img") == 150.0
    split = {k: v for k, v in TOTALS.items() if k != "step.gd_main"}
    split.update({"step.g_main": _t(4, 1.0, 400.0),
                  "step.d_main": _t(4, 1.0, 800.0)})
    monkeypatch.setattr(spans, "totals", lambda: split)
    assert _read("main_ms.train") == 300.0
    # Spans but no host read: none a step, not "not read".
    monkeypatch.setattr(spans, "totals", lambda: {"adapt.step": _t(4, 1.0)})
    assert _read("host_syncs_per_step.adapt") == 0.0
    # Spans recorded on the CPU have no device time.
    monkeypatch.setattr(spans, "totals", lambda: {"augment": _t(4, 1.0)})
    assert _read("augment_pct.train") is None


def test_totals_of_a_program_without_the_recorder(monkeypatch):
    from gagan_tpu_torch.utils import observability

    monkeypatch.delattr(observability, "span_totals")
    assert spans.totals() == {}
