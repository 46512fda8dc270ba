"""The port's calc_metrics command (gagan_tpu_torch/cli/calc_metrics.py) on
the CPU: a tiny snapshot (16^2 generator) and a folder of 6 PNGs, the
random Inception-v3 of the real shape (299^2 input).  ``fid1k`` is run with
the generated count patched from 1000 to 6, so that the test stays small;
everything else is the command's own path: the random-detector warning,
the dataset statistics cached (and read back without the detector),
``metric-fid1k.jsonl`` beside the snapshot,
and the refusal of an unknown metric with the JAX command's message."""

import json
import os

import numpy as np
import pytest
import torch

from gagan_tpu_torch.cli import calc_metrics as cli
from gagan_tpu_torch.data import ImageFolderDataset
from gagan_tpu_torch.metrics import feature_stats as fs
from gagan_tpu_torch.metrics import fid as fid_lib
from gagan_tpu_torch.metrics import metric_main
from gagan_tpu_torch.metrics.detectors import Detector
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils.config import to_dict
from gagan_tpu_torch.utils.png import write_png

torch.set_num_threads(2)

NUM_GEN = 6


def tiny_run(root):
    """(snapshot path, PNG folder) of a 16^2 generator and 6 images."""
    g = tsg.GeneratorConfig(z_dim=16, w_dim=16, img_resolution=16,
                            mapping=tsg.MappingConfig(num_layers=1),
                            synthesis=tsg.SynthesisConfig(channel_base=256,
                                                          channel_max=16))
    snap = os.path.join(root, "run", "network-snapshot-000000.npz")
    tck.save_snapshot(snap, g_ema=tsg.init_generator(
        g, torch.Generator().manual_seed(0), "cpu"),
        config={"g_cfg": to_dict(g)})
    data = os.path.join(root, "data")
    os.makedirs(data)
    rng = np.random.RandomState(0)
    for i in range(6):
        write_png(os.path.join(data, f"{i}.png"),
                  rng.randint(0, 256, (16, 16, 3), np.uint8))
    return snap, data


def few_generated(monkeypatch):
    real = fid_lib.compute_fid

    def compute_fid(opts, max_real, num_gen, **kw):
        return real(opts, max_real, min(num_gen, NUM_GEN), **kw)

    monkeypatch.setattr(fid_lib, "compute_fid", compute_fid)


def test_fid1k_writes_its_line_and_caches(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("GAGAN_DETECTOR_DIR", raising=False)
    few_generated(monkeypatch)
    snap, data = tiny_run(str(tmp_path))
    cache = str(tmp_path / "cache")
    argv = ["--network", snap, "--metrics", "fid1k", "--data", data,
            "--cache-dir", cache, "--batch", "3", "--device", "cpu"]
    (first,) = cli.main(argv)
    err = capsys.readouterr().err
    assert "feature detectors are deterministic RANDOM towers" in err
    value = first["results"]["fid1k"]
    assert np.isfinite(value) and value >= 0
    with open(os.path.join(os.path.dirname(snap), "metric-fid1k.jsonl")) as f:
        (line,) = [json.loads(ln) for ln in f]
    assert line["metric"] == "fid1k" and line["results"]["fid1k"] == value
    assert line["snapshot_pkl"] == os.path.basename(snap)
    # The dataset statistics are cached under the JAX loop's name: a second
    # run reads them without calling the detector.
    (cached,) = os.listdir(cache)
    assert cached.startswith("data-inception-random-")

    def no_call(images):
        raise AssertionError("the dataset statistics were not cached")

    opts = fs.MetricOptions(dataset=ImageFolderDataset(data), cache_dir=cache,
                            device="cpu", detectors={"inception": Detector(
                                "inception-random", no_call, 2048)})
    stats = fs.compute_feature_stats_for_dataset(opts, "inception",
                                                 capture_mean_cov=True)
    assert stats.num_items == 6 and stats.num_features == 2048


def test_unknown_metric_is_refused(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--network", str(tmp_path / "x.npz"), "--metrics",
                  "fid1k,nope", "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert (f"Unknown metric: nope. Valid: "
            f"{metric_main.list_valid_metrics()} or fid<N>k") in err


def test_cuda_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    snap, data = tiny_run(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--network", snap, "--metrics", "fid1k", "--data", data])
