"""The port's latent editors (gagan_tpu_torch/editing) against the JAX
package's: InterFaceGAN's LatentEditor (equal: the same float32 adds),
StyleSpace hooks rendered through ``synthesis_apply`` on a tiny G (2e-4 of
max|JAX|, the suite's forward tolerance), and StyleFlow with JAX's draws
injected (``JaxRng``).

StyleFlow's rk4 grid runs the same float32 operations in the same order:
2e-4.  Its dopri5 accepts a step when the scaled error norm is at most 1;
float32 sums in another order move that norm by ~1e-6, so where it sits at
1.0 the two solvers take another step sequence.  Each solution then stays
within the local tolerance atol + rtol |y| (1e-5 each) a step of the true
one, so two of them lie within twice that over the steps taken (under 10
here): rtol = atol = 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.editing import interfacegan as jig
from gagan_tpu.editing import styleflow as jsf
from gagan_tpu.editing import stylespace as jss
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.params import offsets as joffs
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch import editing as tedit
from gagan_tpu_torch.editing import styleflow as tsf
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.params import offsets as toffs
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils.config import generator_config_from_dict

from .test_torch_augment import JaxRng

torch.set_num_threads(2)


def _close(got, want, tol=2e-4):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# ----------------------------------------------------------------------------
# InterFaceGAN


def test_latent_editor_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    age, smile = rng.randn(8).astype(np.float32), rng.randn(4, 8)
    np.savez(tmp_path / "age.npz", direction=age)
    np.savez(tmp_path / "smile.npz", smile)            # a nameless array
    paths = {"age": str(tmp_path / "age.npz"),
             "smile": str(tmp_path / "smile.npz")}
    jed, ted = jig.LatentEditor.from_files(paths), \
        tedit.LatentEditor.from_files(paths)
    assert sorted(ted.directions) == ["age", "smile"]
    w = rng.randn(2, 4, 8).astype(np.float32)
    for direction in ("age", "smile", age):
        for kw in ({"factor": 1.5}, {"factor_range": (-2, 3)}):
            want = np.asarray(jed.apply_interfacegan(jnp.asarray(w),
                                                     direction, **kw))
            got = ted.apply_interfacegan(torch.from_numpy(w), direction, **kw)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (10, 4, 8)
    for g, j in zip(ted.get_single_interface_gan_edits_with_direction(
            torch.from_numpy(w), [1, -3], "smile"),
            jed.get_single_interface_gan_edits_with_direction(
            jnp.asarray(w), [1, -3], "smile")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


# ----------------------------------------------------------------------------
# StyleSpace


@pytest.fixture(scope="module")
def tiny_g():
    jg = jsg.GeneratorConfig(
        z_dim=16, w_dim=16, img_resolution=16,
        mapping=jsg.MappingConfig(num_layers=1),
        synthesis=jsg.SynthesisConfig(channel_base=256, channel_max=32))
    flat = jck.tree_to_flat(jsg.init_generator(jax.random.PRNGKey(0), jg))
    return (jg, generator_config_from_dict(jconfig.to_dict(jg)),
            jck.flat_to_tree(flat), tck.flat_to_tree(flat))


MODS = [((1, 3), 2.0, 0.5), ((1, 7), -1.5, 0.0), ((4, 0), 3.0, 2.0)]


@pytest.mark.parametrize("base,apply_first", [(False, False), (True, False),
                                              (True, True)])
def test_style_modification_hooks_match_jax(tiny_g, base, apply_first):
    jg, tg, jp, tp = tiny_g
    base_j = base_t = None
    if base:      # a seeded s_delta direction on every layer
        spec = "s_delta"
        offs = jck.tree_to_flat(joffs.init_offsets(
            jax.random.PRNGKey(1), jg.synthesis,
            joffs.OffsetsSpec.from_string(spec)))
        rng = np.random.RandomState(2)
        offs = {k: rng.randn(*v.shape).astype(np.float32) * 0.3
                for k, v in offs.items()}
        base_j = joffs.make_hooks(joffs.OffsetsSpec.from_string(spec),
                                  _layer_tree(offs, jnp.asarray))
        base_t = toffs.make_hooks(toffs.OffsetsSpec.from_string(spec),
                                  _layer_tree(offs, torch.from_numpy))
    jh = jss.build_style_modification_hooks(jg.synthesis, MODS, base_j,
                                            apply_first)
    th = tedit.build_style_modification_hooks(tg.synthesis, MODS, base_t,
                                              apply_first)
    assert sorted(th) == sorted(jh)
    ws = np.random.RandomState(3).randn(2, jg.num_ws, 16).astype(np.float32)
    want = jsg.synthesis_apply(jg.synthesis, jp["synthesis"], jnp.asarray(ws),
                               noise_mode="const", hooks=jh)
    got = tsg.synthesis_apply(tg.synthesis, tp["synthesis"],
                              torch.from_numpy(ws), noise_mode="const",
                              hooks=th)
    _close(got, want)
    plain = tsg.synthesis_apply(tg.synthesis, tp["synthesis"],
                                torch.from_numpy(ws), noise_mode="const",
                                hooks=base_t)
    assert not torch.allclose(got, plain)
    if not base:          # a zero edit renders the plain image bit for bit
        zero = tedit.build_style_modification_hooks(
            tg.synthesis, [((1, 3), 0.0, 1.0)])
        same = tsg.synthesis_apply(tg.synthesis, tp["synthesis"],
                                   torch.from_numpy(ws), noise_mode="const",
                                   hooks=zero)
        assert torch.equal(same, plain)


def _layer_tree(flat, to):
    """{"b<res>.<layer>": {leaf: ...}}: offsets keep the layer's dot."""
    out = {}
    for k, v in flat.items():
        name, leaf = k.rsplit(".", 1)
        out.setdefault(name, {})[leaf] = to(v)
    return out


# ----------------------------------------------------------------------------
# StyleFlow

SMALL = dict(input_dim=16, hidden_dims=(32, 32), context_dim=5)


def _flows(solver, **kw):
    jcfg = jsf.StyleFlowConfig(**SMALL, solver=solver, **kw)
    tcfg = tsf.StyleFlowConfig(**SMALL, solver=solver, **kw)
    key = jax.random.PRNGKey(0)
    jp = jsf.init_styleflow(key, jcfg)
    tp = tsf.init_styleflow(JaxRng(key), tcfg)
    flat = jck.tree_to_flat(jp)
    got = tck.tree_to_flat(tp)
    assert sorted(got) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], np.asarray(flat[k]), err_msg=k)
    # Weights x30 and a longer time for dynamics that move x by O(1); batch
    # norms off identity.
    rng = np.random.RandomState(1)
    for k, v in flat.items():
        if "layers" in k and k.endswith("weight"):
            flat[k] = np.asarray(v) * 30
        elif k.startswith("bn."):
            flat[k] = (rng.uniform(0.5, 2.0, v.shape) if "var" in k else
                       rng.randn(*v.shape) * 0.2).astype(np.float32)
        elif k.endswith("sqrt_end_time"):
            flat[k] = np.float32(1.2)
    return jcfg, tcfg, jck.flat_to_tree(flat), tck.flat_to_tree(flat)


@pytest.mark.parametrize("solver,tol", [("rk4", 2e-4), ("dopri5", None)])
def test_flow_apply_matches_jax(solver, tol):
    jcfg, tcfg, jp, tp = _flows(solver, rk4_steps=20)
    rng = np.random.RandomState(2)
    x = rng.randn(6, 16).astype(np.float32)
    ctx = rng.randn(6, 5).astype(np.float32)
    tsf.DOPRI5_STATS.update(steps=0, host_reads=0)
    for reverse in (False, True):
        want = np.asarray(jsf.flow_apply(jp, jcfg, jnp.asarray(x),
                                         jnp.asarray(ctx), reverse=reverse))
        got = tsf.flow_apply(tp, tcfg, torch.from_numpy(x),
                             torch.from_numpy(ctx), reverse=reverse).numpy()
        assert np.abs(want - x).max() > 0.5
        if tol:
            _close(got, want, tol)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    steps = tsf.DOPRI5_STATS["steps"]
    assert (steps > 0) == (solver == "dopri5")
    assert tsf.DOPRI5_STATS["host_reads"] == steps + 2 * (steps > 0)
    back = tsf.flow_apply(tp, tcfg, tsf.flow_apply(
        tp, tcfg, torch.from_numpy(x), torch.from_numpy(ctx)),
        torch.from_numpy(ctx), reverse=True).numpy()
    np.testing.assert_allclose(back, x, rtol=1e-3, atol=1e-3)


def test_reference_fault_dopri5_stops_silently_at_max_steps():
    """``_dopri5`` (gagan_tpu/editing/styleflow.py:135-137) ends its loop at
    max_steps without a word, short of t1; torchdiffeq raises instead.  The
    port keeps the JAX behaviour: the same unfinished state, no error
    (after one step, before the two could take different steps)."""
    jcfg, tcfg, jp, tp = _flows("dopri5", max_steps=1)
    _, full_cfg, _, _ = _flows("dopri5")
    x = np.random.RandomState(3).randn(4, 16).astype(np.float32)
    ctx = np.random.RandomState(4).randn(4, 5).astype(np.float32)
    want = np.asarray(jsf.flow_apply(jp, jcfg, jnp.asarray(x),
                                     jnp.asarray(ctx)))
    tsf.DOPRI5_STATS.update(steps=0, host_reads=0)
    got = tsf.flow_apply(tp, tcfg, torch.from_numpy(x),
                         torch.from_numpy(ctx)).numpy()
    assert tsf.DOPRI5_STATS["steps"] == 1
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    full = tsf.flow_apply(tp, full_cfg, torch.from_numpy(x),
                          torch.from_numpy(ctx)).numpy()
    assert np.abs(full - got).max() > 1e-2


def test_torch_state_to_tree_is_bit_equal():
    cfg = jsf.StyleFlowConfig(**SMALL, num_blocks=2)
    tcfg = tsf.StyleFlowConfig(**SMALL, num_blocks=2)
    rng = np.random.RandomState(5)
    sd = {}
    for c in (0, 2, 4):
        for leaf in ("running_mean", "running_var", "weight", "bias"):
            sd[f"chain.{c}.{leaf}"] = rng.randn(16).astype(np.float32)
    dims = (16, 32, 32, 16)
    for c in (1, 3):
        sd[f"chain.{c}.sqrt_end_time"] = rng.randn(1).astype(np.float32)
        for i in range(3):
            p = f"chain.{c}.odefunc.diffeq.layers.{i}."
            sd[p + "_layer.weight"] = rng.randn(dims[i + 1], dims[i])
            sd[p + "_layer.bias"] = rng.randn(dims[i + 1])
            sd[p + "_hyper_bias.weight"] = rng.randn(dims[i + 1], 6)
            sd[p + "_hyper_gate.weight"] = rng.randn(dims[i + 1], 6)
            sd[p + "_hyper_gate.bias"] = rng.randn(dims[i + 1])
    sd = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}
    want = jck.tree_to_flat(jsf.torch_state_to_tree(sd, cfg))
    got = tck.tree_to_flat(tsf.torch_state_to_tree(sd, tcfg))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("solver,attr", [("rk4", 0), ("dopri5", 5)])
def test_styleflow_editor_matches_jax(solver, attr):
    cfg = dict(input_dim=32, hidden_dims=(64,), context_dim=17, solver=solver,
               rk4_steps=30)
    key = jax.random.PRNGKey(6)
    jcfg, tcfg = jsf.StyleFlowConfig(**cfg), tsf.StyleFlowConfig(**cfg)
    jp = jsf.init_styleflow(key, jcfg)
    flat = {k: (np.asarray(v) * 40 if "layers" in k and k.endswith("weight")
                else np.asarray(v)) for k, v in jck.tree_to_flat(jp).items()}
    jed = jsf.StyleFlowEditor(jck.flat_to_tree(flat), jcfg)
    ted = tsf.StyleFlowEditor(tck.flat_to_tree(flat), tcfg)
    rng = np.random.RandomState(7)
    w = rng.randn(1, 18, 32).astype(np.float32)
    attrs = rng.uniform(0, 1, 8).astype(np.float32)
    light = rng.uniform(0, 1, 9).astype(np.float32)
    want = np.asarray(jed.edit(jnp.asarray(w), attrs, light, attr, 0.8))
    got = ted.edit(torch.from_numpy(w), attrs, light, attr, 0.8)
    assert tuple(got.shape) == (1, 18, 32)
    if solver == "rk4":
        _close(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    for start, end in tsf._PRESERVE[attr]:
        np.testing.assert_array_equal(got[:, start:end].numpy(),
                                      w[:, start:end])
    assert np.abs(got.numpy() - w).max() > 1e-3
