"""The benchmark finds every file of a cell by name, and a cell, traffic
mix or per-layer metric dropped in is found without an edit."""

import json
import os
import shutil

import pytest

from portbench import harness
from tests_root import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found(cell):
    c = harness.load_cell(ROOT, cell)
    assert os.path.isfile(os.path.join(harness.HERE, "jobs",
                                       c.traffic["job"] + ".py"))
    for m in c.per_layer:
        assert os.path.isfile(os.path.join(harness.HERE, "layers",
                                           m["name"] + ".py"))
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names


def test_configs_hold_their_reduced_and_source():
    for cfg in BENCH["configs"]:
        data = json.load(open(os.path.join(ROOT, cfg["file"])))
        assert data["name"] == cfg["name"]
        assert data["reduced"] == cfg["reduced"] == []


def test_new_files_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    src = root / "portbench" / "traffic"
    (src / "generate-b8.json").write_text(json.dumps(
        dict(json.loads((src / "generate-b32.json").read_text()), batch=8)))
    (root / "portbench" / "layers" / "images_per_step.img.py").write_text(
        "def read(r):\n    return r.work['images'] / r.work['steps']\n")
    bench["workloads"].append({"name": "ffhq1024-generate-b8",
                               "config": "stylegan2-f-ffhq1024",
                               "traffic": "generate-b8", "chips": 1,
                               "why": "a smaller batch"})
    bench["end_to_end"][1]["workloads"].append("ffhq1024-generate-b8")
    bench["per_layer"].append({"name": "images_per_step.img", "unit": "img",
                               "better": "higher", "source": "program_counter",
                               "layer": "model step", "moves": "img_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(str(root), "ffhq1024-generate-b8")
    assert cell.traffic["batch"] == 8
    assert "images_per_step.img" in {m["name"] for m in cell.per_layer}
    reading = harness.Reading(harness.TraceReading(1.0, 0.5, {}, {}, 0, []),
                              {"images": 64, "steps": 8}, 0)
    assert harness.read_layers(cell, reading)["images_per_step.img"] == {
        "value": 8.0, "unit": "img"}


def test_unknown_cell_is_refused():
    with pytest.raises(harness.SetupError):
        harness.load_cell(ROOT, "no-such-cell")


def _run(cwd):
    import subprocess
    import sys

    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ffhq1024-generate",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_without_the_port_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "gagan_tpu_torch" in out.stderr


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
