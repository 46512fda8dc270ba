"""The port stands alone: nothing in gagan_tpu_torch/ or chip_smoke.py imports
JAX or the JAX package, the port imports with JAX blocked, and its CUDA
entry points refuse to run (rather than fall back) without a CUDA device."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"^(jax|jaxlib|gagan_tpu(?!_torch))(\.|$)")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "gagan_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_jax_imports_in_port():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{path}:{node.lineno} {m}" for m in mods
                    if FORBIDDEN.match(m)]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['gagan_tpu'] = None\n"
            "import gagan_tpu_torch, gagan_tpu_torch.models.stylegan2, "
            "gagan_tpu_torch.ops.fused_modconv, gagan_tpu_torch.cli.generate, "
            "gagan_tpu_torch.entry, gagan_tpu_torch.train.augment, "
            "gagan_tpu_torch.train.gan_loss, gagan_tpu_torch.train.masks, "
            "gagan_tpu_torch.train.train_step, gagan_tpu_torch.ga, "
            "gagan_tpu_torch.ga.refine, gagan_tpu_torch.utils.rng, "
            "gagan_tpu_torch.utils.config\n"
            "assert 'triton' not in sys.modules\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _port_modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        if rel != "chip_smoke":
            mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                        else rel)
    return mods


def test_port_imports_with_pil_and_click_blocked():
    """The card's machine has neither Pillow nor click: every module of the
    port imports without them (and without JAX)."""
    mods = _port_modules()
    assert {"gagan_tpu_torch.train.loop", "gagan_tpu_torch.cli.train",
            "gagan_tpu_torch.cli.style_mixing", "gagan_tpu_torch.data.dataset",
            "gagan_tpu_torch.utils.png", "gagan_tpu_torch.utils.stats",
            "gagan_tpu_torch.utils.observability",
            "gagan_tpu_torch.utils.registry"} <= set(mods)
    code = ("import importlib, sys\n"
            "for m in ('PIL', 'click', 'jax', 'gagan_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "assert 'triton' not in sys.modules\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gagan_tpu_torch import entry

    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.train_entry()


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    here = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert here.returncode != 0
    assert '"ok"' not in here.stdout and "is_available() is False" in here.stderr
    alone = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        alone.write_text(f.read())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
