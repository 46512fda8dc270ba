"""Nothing that the benchmark loads imports JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import glob
import os
import subprocess
import sys

from tests_root import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gagan_tpu"}

PROBE = r"""
import importlib, os, sys


class NoTensorFlow:
    # As on the card's machine, which has no TensorFlow: here TensorFlow
    # (which torch.utils.tensorboard loads when it is present) loads JAX.
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] == "tensorflow":
            raise ImportError("no TensorFlow")
        return None


sys.meta_path.insert(0, NoTensorFlow())
sys.path.insert(0, {root!r})
sys.path.insert(0, os.path.join({root!r}, "portbench", "tests"))
for mod in {mods!r}:
    importlib.import_module(mod)
if {cells!r}:
    import tiny
    for cell in {cells!r}:
        tiny.run(cell)
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(mods=(), cells=()):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, mods=list(mods),
                                            cells=list(cells))],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split()[-1000:])


def test_runs_load_no_jax():
    """A tiny CPU run of each kind of job, then sys.modules."""
    names = _top_level(["portbench.run", "portbench.control"],
                       ["ffhq1024-generate", "ffhq1024-oneshot-clip",
                        "ffhq1024-fewshot10"])
    assert "gagan_tpu_torch" in names          # the jobs ran the port
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    mods = []
    ref = os.path.join(ROOT, "portbench", "reference")
    for path in glob.glob(os.path.join(ref, "**", "*.py"), recursive=True):
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    names = _top_level(mods=mods)
    assert not names & (FORBIDDEN | {"gagan_tpu_torch"})


def test_forbidden_check_compares_whole_names():
    from portbench import harness

    sys.modules.setdefault("gagan_tpu_torch_probe_only", sys)
    try:
        assert "gagan_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["gagan_tpu_torch_probe_only"]
