"""The port's statistics, observability, registry and dotlist helpers
(gagan_tpu_torch.utils.{stats,observability,registry,config}) against the JAX
package's: the Collector's moments, the stats.jsonl lines, the histogram
names, the parameter fingerprint and summary, the registry's dataclasses and
the dotlist overrides.  Values are float64 sums of the same numbers: equal
to 1e-12 relative."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.utils import config as jconfig
from gagan_tpu.utils import observability as jobs
from gagan_tpu.utils import registry as jreg
from gagan_tpu.utils import stats as jstats
from gagan_tpu_torch.utils import config as tconfig
from gagan_tpu_torch.utils import observability as tobs
from gagan_tpu_torch.utils import registry as treg
from gagan_tpu_torch.utils import stats as tstats


def T(v):
    return torch.from_numpy(np.array(v))


def J(v):
    return jnp.asarray(np.array(v))


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _metrics(seed):
    rng = np.random.RandomState(seed)
    return {"Loss/G/loss": np.float32(rng.randn()),
            "Loss/signs/real": np.float32(rng.uniform(-1, 1)),
            "Loss/scores/fake": rng.randn(3).astype(np.float32),
            "aux/mean_w": rng.randn(4).astype(np.float32)}


def _fill(module, to):
    c = module.Collector()
    for step in range(5):
        c.report_dict({k: to(v) for k, v in _metrics(step).items()})
    c.report("Extra", to(np.float32(2.5)))
    return c


def test_collector_matches_jax():
    got = _fill(tstats, T)
    want = _fill(jstats, J)
    assert set(got.as_dict()) == set(want.as_dict()) == {
        "Loss/G/loss", "Loss/signs/real", "Loss/scores/fake", "Extra"}
    for k, w in want.as_dict().items():
        g = got.as_dict()[k]
        assert g["num"] == w["num"]
        assert g["mean"] == pytest.approx(w["mean"], rel=1e-12, abs=1e-15)
        assert g["std"] == pytest.approx(w["std"], rel=1e-12, abs=1e-15)
    assert got.mean("absent", 7.0) == want.mean("absent", 7.0) == 7.0
    got.reset()
    assert got.as_dict() == {}


def test_to_host_keeps_order_and_shapes():
    vals = [torch.tensor(1.5), 2, torch.arange(6.0).reshape(2, 3),
            np.float32(3.0)]
    out = tstats.to_host(vals)
    assert [o.shape for o in out] == [(), (), (2, 3), ()]
    assert [float(o.sum()) for o in out] == [1.5, 2.0, 15.0, 3.0]
    assert all(o.dtype == np.float64 for o in out)


def test_stats_jsonl_matches_jax(tmp_path):
    extra = {"Progress/tick": 3, "Progress/kimg": 1.024,
             "Timing/sec_per_kimg": 12.5}
    lines = {}
    for name, module, to in (("jax", jstats, J),
                             ("torch", tstats, T)):
        logger = module.StatsLogger(str(tmp_path / name),
                                    use_tensorboard=False)
        logger.write(_fill(module, to), step=1024, extra=extra)
        logger.close()
        with open(tmp_path / name / "stats.jsonl") as f:
            lines[name] = json.loads(f.readline())
    got, want = lines["torch"], lines["jax"]
    assert list(got) == list(want)
    for k, v in want.items():
        if k != "timestamp":
            assert got[k] == pytest.approx(v, rel=1e-12), k


def test_histogram_names_match_jax(tmp_path):
    names = {}

    class FakeWriter:
        def __init__(self, sink):
            self.sink = sink

        def add_histogram(self, name, values, global_step):
            self.sink.append((name, np.asarray(values).shape, global_step))

        def flush(self):
            pass

    tree = {"mapping": {"fc0": {"weight": np.ones((2, 3), np.float32)}},
            "synthesis": {"b4": {"const": np.zeros((4, 4, 4), np.float32),
                                 "conv1": {"noise_strength":
                                           np.float32(0.5)}}}}
    for name, module, to in (("jax", jstats, J),
                             ("torch", tstats, T)):
        logger = module.StatsLogger(str(tmp_path / name),
                                    use_tensorboard=False)
        names[name] = []
        logger._tb = FakeWriter(names[name])
        logger.log_histograms({"G": _map(to, tree)}, step=8)
    assert sorted(names["torch"]) == sorted(names["jax"])
    assert ("G/synthesis.b4.conv1.noise_strength", (), 8) in names["torch"]


def test_stats_logger_tensorboard_and_wandb(tmp_path, monkeypatch):
    import sys
    import types

    logger = tstats.StatsLogger(str(tmp_path / "tb"))
    logger.log_histograms({"G": {"w": torch.ones(3)}}, step=1)
    c = tstats.Collector()
    c.report("Loss/G/loss", torch.tensor(1.0))
    logger.write(c, step=1)
    logger.close()

    calls = []
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: calls.append(("init", kw))
    stub.log = lambda payload, step=None: calls.append(("log", payload, step))
    stub.finish = lambda: calls.append(("finish",))
    stub.Image = lambda a: a
    monkeypatch.setitem(sys.modules, "wandb", stub)
    logger = tstats.StatsLogger(str(tmp_path / "wb"), use_tensorboard=False,
                                use_wandb=True)
    logger.write(c, step=5)
    logger.log_images(np.zeros((2, 4, 4, 3), np.uint8), step=6)
    logger.close()
    assert [x[0] for x in calls] == ["init", "log", "log", "finish"]
    assert calls[1][1] == {"Loss/G/loss": 1.0} and calls[1][2] == 5


def _tree(to):
    return {"synthesis": {"b4": {"w": to(np.arange(6.0).reshape(2, 3))}},
            "mapping": {"fc0": {"bias": to(np.ones(5)),
                                "weight": to(np.full((3, 3), 0.5))}}}


def test_fingerprint_and_summary_match_jax():
    np.testing.assert_allclose(
        tobs.params_fingerprint(_tree(torch.tensor)),
        jobs.params_fingerprint(_tree(jnp.asarray)), rtol=1e-12)
    assert (tobs.summarize_params(_tree(torch.tensor), "G")
            == jobs.summarize_params(_tree(jnp.asarray), "G"))
    assert not tobs.nan_guard(_tree(torch.tensor))
    assert tobs.nan_guard({"x": {"y": torch.tensor([1.0, float("nan")])}})
    tobs.check_cross_host_consistency(_tree(torch.tensor))  # one process


def test_assert_shape_timer_and_spans(tmp_path):
    x = torch.zeros((2, 3, 4))
    tobs.assert_shape(x, [2, None, 4])
    for bad in ([2, 3], [2, 3, 5]):
        with pytest.raises(AssertionError):
            tobs.assert_shape(x, bad)
    # The span recorder: forced on, then under the TensorBoard profiler.
    tobs.reset_spans()
    was = tobs.recording(True)
    try:
        with tobs.trace_scope("matmul"):
            x.reshape(6, 4) @ x.reshape(6, 4).T
    finally:
        tobs.recording(was)
    t = tobs.span_totals()["matmul"]
    assert t["count"] == 1 and t["host_ms"] >= 0 and t["device_ms"] is None
    tobs.reset_spans()
    with tobs.profile_trace(str(tmp_path / "prof")):
        with tobs.trace_scope("span"):
            torch.ones(4).sum()
    assert any((tmp_path / "prof").iterdir())
    assert list(tobs.span_totals()) == ["span"]
    tobs.reset_spans()
    assert not hasattr(tobs, "PhaseTimer")


def test_registry_matches_jax():
    def build(m):
        reg = m.ClassRegistry()

        @reg.add_to_registry(["a", "alias"])
        class A:
            def __init__(self, x, y=2, z=None, name="n"):
                pass

        @reg.add_to_registry("f", arg_keys=["enc", "dec"])
        def f(lr=0.1, steps=3):
            pass

        return reg

    got, want = build(treg), build(jreg)
    assert repr(got) == repr(want) and "alias" in got
    for name in ("a", "alias", "f"):
        g, w = got.args[name](), want.args[name]()
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert ([f.name for f in dataclasses.fields(got.make_dataclass_from_args())]
            == [f.name for f in dataclasses.fields(
                want.make_dataclass_from_args())])


def test_apply_dotlist_matches_jax():
    overrides = ["a.b=3", "a.c=[1, 2]", "name=hello", "x.y.z=1e-3",
                 "flag=True"]
    base = {"a": {"b": 1, "d": 4}}
    got = tconfig.apply_dotlist(json.loads(json.dumps(base)), overrides)
    assert got == jconfig.apply_dotlist(json.loads(json.dumps(base)),
                                        overrides)
    assert got["a"] == {"b": 3, "d": 4, "c": [1, 2]} and got["name"] == "hello"
