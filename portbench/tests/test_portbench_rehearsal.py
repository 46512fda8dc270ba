"""A tiny CPU run of each cell's job: it agrees with the plain
reference with the program in float32, and prints a last line with the
contract's keys.  A rehearsal of the control flow, not a device
measurement."""

import io
import json
import contextlib

import pytest

import tiny
from portbench import harness

# A tiny float32 run reads nearly nothing against the reference: the
# frozen copy is the same arithmetic, up to the order of a few sums (the
# packed tail, the fused level's plain version).
SOUND = {"ffhq1024-fewshot10": 1e-5, "ffhq256-paper256": 1e-5,
         "ffhq1024-generate": 0.1, "ffhq1024-oneshot-clip": 1e-3}


@pytest.mark.parametrize("cell", sorted(SOUND))
def test_tiny_run_agrees_and_prints_the_contract(cell):
    result = tiny.run(cell)
    for name, c in result["checks"].items():
        assert c["value"] <= SOUND[cell], (name, c)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        harness.print_result(result)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0
    assert "setup_s" in line["metrics"]
    parts = line["setup_parts"]
    assert {"start", "warm"} <= set(parts)
    assert sum(parts.values()) == pytest.approx(
        line["metrics"]["setup_s"]["value"], abs=1e-6)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])


def test_tiny_traced_run_reports_layers_not_on_the_cpu():
    """Traced on the CPU, no device metric is read: the readers of a
    device trace return nothing, and the line holds no busy time."""
    result = tiny.run("ffhq1024-generate", trace=True)
    assert "idle_pct.img" not in result["metrics"]
    assert result["device"]["busy_s"] == 0.0
