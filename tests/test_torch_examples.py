"""The port's five examples (``gagan_tpu_torch/examples``) against the JAX
package's scripts (``examples/*.py``) on the CPU: the same snapshot and
adaptation checkpoints (``entry.examples_entry`` at 32^2), the same
latents (the scripts' numpy draws, and JAX's ``jax.random`` latents handed
to the port's ``draw_latents`` where the JAX script draws them), and the
PNGs compared pixel for pixel.  The JAX scripts run in this process with
their own command lines.

Tolerance: two uint8 levels, and at most 2% of the values a level or two
apart: the generators agree within the suite's 2e-4 of max|img| and the
resizes within a float rounding (``tests/test_torch_image_utils.py``), and
a value within that of a .5 rounds to the other level.
"""

import importlib
import os
import sys

import jax
import numpy as np
import pytest
import torch

from gagan_tpu_torch import entry
from gagan_tpu_torch.utils import png

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("examples"))
    return work, entry.examples_entry("cpu", 32, work)


def _jax_argv(argv, outdir):
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--device", "--outdir"):
            skip = True
            continue
        out.append(a)
    return out + ["--outdir", outdir]


def _run_jax(name, argv, monkeypatch):
    # The scripts import each other both as `examples.<name>` and as
    # top-level modules (`from quick_start import ...`).
    monkeypatch.setattr(sys, "path",
                        [os.path.join(REPO, "examples"), REPO] + sys.path)
    module = importlib.import_module(f"examples.{name}")
    monkeypatch.setattr(sys, "argv", [name] + argv)
    module.main()


@pytest.mark.parametrize("name", entry.EXAMPLES)
def test_example_matches_the_jax_script(name, inputs, tmp_path, monkeypatch):
    work, argvs = inputs
    argv = list(argvs[name])
    port_out = os.path.join(work, name)
    jax_out = str(tmp_path / "jax")
    if name in ("morphing", "pruned_forward"):
        module = importlib.import_module(f"gagan_tpu_torch.examples.{name}")
        monkeypatch.setattr(module, "draw_latents", lambda seed, n, z_dim,
                            device: torch.from_numpy(np.array(
                                jax.random.normal(jax.random.PRNGKey(seed),
                                                  (n, z_dim)))).to(device))
    module = importlib.import_module(f"gagan_tpu_torch.examples.{name}")
    written = module.main(argv)
    assert written and all(p.startswith(port_out) for p in written)
    _run_jax(name, _jax_argv(argv, jax_out), monkeypatch)
    assert sorted(os.listdir(jax_out)) == sorted(
        os.path.basename(p) for p in written)
    for path in written:
        got = png.read_png(path)
        want = png.read_png(os.path.join(jax_out, os.path.basename(path)))
        assert got.shape == want.shape and got.dtype == np.uint8
        assert got.std() > 10                        # an image, not a fill
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 2, path
        assert (diff > 0).mean() <= 0.02, path


@pytest.mark.parametrize("name", ["quick_start", "editing"])
def test_random_weights_demo_at_res_32(name, tmp_path):
    """Without --network: a random G of the default config at --res."""
    module = importlib.import_module(f"gagan_tpu_torch.examples.{name}")
    written = module.main(["--res", "32", "--device", "cpu", "--outdir",
                           str(tmp_path)])
    assert written and all(os.path.exists(p) for p in written)
    assert png.read_png(written[0]).ndim == 3


@pytest.mark.parametrize("name", ["adaptation_inference", "morphing",
                                  "pruned_forward"])
def test_examples_without_network_write_a_random_source(name, inputs,
                                                        tmp_path):
    """Without --network the checkpoint's embedded config gives a random
    source generator, written beside the outputs."""
    _, argvs = inputs
    ckpt = argvs[name][argvs[name].index("--ckpt") + 1]
    module = importlib.import_module(f"gagan_tpu_torch.examples.{name}")
    extra = ["--n", "2"] if name == "adaptation_inference" else [
        "--n-latents", "2"]
    if name == "morphing":
        extra += ["--frames", "2"]
    written = module.main(["--ckpt", ckpt, "--device", "cpu", "--outdir",
                           str(tmp_path)] + extra)
    assert os.path.exists(tmp_path / "source_random.npz")
    assert written and all(os.path.exists(p) for p in written)


def test_examples_refuse_cuda_without_a_card(inputs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from gagan_tpu_torch.examples import quick_start

    with pytest.raises(RuntimeError, match="device='cpu'"):
        quick_start.main(["--res", "32"])
