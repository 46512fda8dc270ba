"""Weight import without JAX: the port's state-dict importers
(gagan_tpu_torch/utils/torch_import.py, clip/convert.py) and its converter
command (gagan_tpu_torch/cli/convert_weights.py) against the JAX package's
(gagan_tpu/utils/torch_import.py, gagan_tpu/clip/convert.py) and
tools/convert_weights.py (imported by path), on random state dicts built
here from seeds.  The command's npz files are read back by the JAX
package's loaders.  Conversion copies values, so every comparison is exact
except ``w_avg``, a mean over the mapping network (2e-4 of max|w_avg|, the
suite's forward tolerance).
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gagan_tpu.clip import convert as jconv
from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu.utils import torch_import as jti
from gagan_tpu_torch.cli import convert_weights as tcw
from gagan_tpu_torch.clip import convert as tconv
from gagan_tpu_torch.metrics import alexnet as talex
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils import torch_import as tti

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tool():
    """tools/convert_weights.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "convert_weights_tool", os.path.join(REPO, "tools",
                                             "convert_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_trees(got, want):
    gflat, wflat = tck.tree_to_flat(got), jck.tree_to_flat(want)
    assert sorted(gflat) == sorted(wflat)
    for k, v in wflat.items():
        v = np.asarray(v)
        # JAX narrows int64 scalars (OpenAI's context_length) to int32.
        assert gflat[k].dtype == v.dtype or (
            gflat[k].dtype.kind == v.dtype.kind == "i"), k
        np.testing.assert_array_equal(gflat[k], v, err_msg=k)


# ----------------------------------------------------------------------------
# NVlabs state dicts


def _nvlabs_sd(seed=0, res=16):
    """A G state dict in NVlabs' layout (the JAX init's keys) with the
    buffers NVlabs modules carry and the tree does not."""
    g = jsg.GeneratorConfig(z_dim=16, w_dim=16, img_resolution=res,
                            mapping=jsg.MappingConfig(num_layers=2),
                            synthesis=jsg.SynthesisConfig(channel_base=128,
                                                          channel_max=16))
    sd = {k: np.asarray(v) for k, v in jck.tree_to_flat(
        jsg.init_generator(jax.random.PRNGKey(seed), g)).items()}
    f = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64
    for r in g.synthesis.block_resolutions[1:]:
        sd[f"synthesis.b{r}.resample_filter"] = f
        sd[f"synthesis.b{r}.conv0.resample_filter"] = f
        sd[f"synthesis.b{r}.conv1.resample_filter"] = f
    sd["synthesis.b8.conv0.ones"] = np.ones(3, np.float32)
    sd["synthesis.b8.conv1.ones_weights"] = np.ones(3, np.float32)
    sd["synthesis.b8.torgb.offset_mask"] = np.ones(3, np.float32)
    return g, sd


@pytest.mark.parametrize("extra", [{}, {"ones": 1.0, "offset_mask": 2.0,
                                        "resample_filter": 3.0,
                                        "a.onesies": 4.0}])
def test_nest_state_dict_matches_jax(extra):
    """The dropped buffers, and the JAX function's second test: a key equal
    to a suffix without its dot ("ones", "offset_mask") is dropped too, a
    key that merely ends in the letters ("a.onesies") is kept."""
    _, sd = _nvlabs_sd()
    sd.update({k: np.float32(v) for k, v in extra.items()})
    want = jti.nest_state_dict(sd)
    got = tti.nest_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()})
    _same_trees(got, want)
    flat = tck.tree_to_flat(got)
    assert not any(k.endswith(("resample_filter", ".ones", ".ones_weights",
                               ".offset_mask")) for k in flat)
    assert ("a.onesies" in flat) == ("a.onesies" in extra)
    assert "ones" not in flat and "offset_mask" not in flat
    for fn_t, fn_j in ((tti.generator_params_from_nvlabs,
                        jti.generator_params_from_nvlabs),
                       (tti.discriminator_params_from_nvlabs,
                        jti.discriminator_params_from_nvlabs)):
        _same_trees(fn_t(sd), fn_j(sd))


def test_split_offsets_matches_jax():
    """Offset leaves inside the layers (offset, weights_offset*, affine's
    weights_offset*) move to a tree keyed 'b<res>.<layer>'; the params
    lose them."""
    _, sd = _nvlabs_sd(1)
    rng = np.random.RandomState(2)
    sd["synthesis.b8.conv0.offset"] = rng.randn(1, 16).astype(np.float32)
    sd["synthesis.b8.conv0.weights_offset"] = rng.randn(16, 16, 1, 1).astype(
        np.float32)
    sd["synthesis.b16.torgb.affine.weights_offset_in_0"] = rng.randn(
        2, 16).astype(np.float32)
    sd["synthesis.b16.torgb.affine.weights_offset_out_0"] = rng.randn(
        16, 2).astype(np.float32)
    sd["synthesis.b4.conv1.weights_offset_out_0"] = rng.randn(16, 1).astype(
        np.float32)
    jparams = jti.nest_state_dict(sd)
    tparams = tti.nest_state_dict(sd)
    joff, toff = jti.split_offsets(jparams), tti.split_offsets(tparams)
    assert sorted(toff) == sorted(joff) == ["b16.torgb", "b4.conv1",
                                            "b8.conv0"]
    _same_trees(toff, joff)
    _same_trees(tparams, jparams)
    assert "offset" not in tparams["synthesis"]["b8"]["conv0"]
    assert "weights_offset_in_0" not in tparams["synthesis"]["b16"]["torgb"][
        "affine"]


def test_nvlabs_command_writes_what_jax_loads(tmp_path):
    """nvlabs: a torch.save'd {"G", "G_ema", "D"} dict -> a snapshot whose
    leaves equal the source tensors bit for bit, without the dropped
    buffers, and whose g_cfg is the one the JAX tool reads off the
    module."""
    g, gsd = _nvlabs_sd(3)
    _, esd = _nvlabs_sd(4)
    d = jsg.DiscriminatorConfig(img_resolution=16, channel_base=128,
                                channel_max=16)
    dsd = {k: np.asarray(v) for k, v in jck.tree_to_flat(
        jsg.init_discriminator(jax.random.PRNGKey(5), d)).items()}
    dsd["b16.resample_filter"] = np.ones((4, 4), np.float32)
    src, dest = str(tmp_path / "nets.pt"), str(tmp_path / "nets.npz")
    torch.save({name: {k: torch.from_numpy(np.asarray(v)) for k, v in
                       sd.items()}
                for name, sd in (("G", gsd), ("G_ema", esd), ("D", dsd))},
               src)
    tcw.main(["nvlabs", "--src", src, "--dest", dest])
    trees, config = jck.load_snapshot(dest)
    for name, sd in (("G", gsd), ("G_ema", esd), ("D", dsd)):
        flat = jck.tree_to_flat(trees[name])
        kept = {k: v for k, v in sd.items() if not k.endswith(
            ("resample_filter", ".ones", ".ones_weights", ".offset_mask"))}
        assert sorted(flat) == sorted(kept) and len(kept) < len(sd)
        for k, v in kept.items():
            np.testing.assert_array_equal(np.asarray(flat[k]), v, err_msg=k)
    assert config == {"g_cfg": {"z_dim": 16, "c_dim": 0, "w_dim": 16,
                                "img_resolution": 16, "img_channels": 3}}
    assert jconfig.generator_config_from_dict(config["g_cfg"]).z_dim == 16


def _nvlabs_nets():
    """{"G", "G_ema", "D"} NVlabs-layout state dicts (with the buffers the
    converters drop) as tensors, and G's attributes."""
    g, gsd = _nvlabs_sd(6)
    _, esd = _nvlabs_sd(7)
    d = jsg.DiscriminatorConfig(img_resolution=16, channel_base=128,
                                channel_max=16)
    dsd = {k: np.asarray(v) for k, v in jck.tree_to_flat(
        jsg.init_discriminator(jax.random.PRNGKey(8), d)).items()}
    dsd["b16.conv0.resample_filter"] = np.ones((4, 4), np.float32)
    nets = {name: {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
            for name, sd in (("G", gsd), ("G_ema", esd), ("D", dsd))}
    attrs = dict(z_dim=g.z_dim, c_dim=g.c_dim, w_dim=g.w_dim,
                 img_resolution=g.img_resolution, img_channels=3)
    return nets, attrs


@pytest.fixture
def nvlabs_pkl(tmp_path):
    """A stand-in NVlabs network pickle and the checkout that defines its
    classes (``entry.write_nvlabs_pickle``); ``training`` is importable
    neither before nor after."""
    from gagan_tpu_torch import entry

    nets, attrs = _nvlabs_nets()
    ref, src = str(tmp_path / "reference"), str(tmp_path / "snap.pkl")
    entry.write_nvlabs_pickle(src, ref, nets, attrs)
    assert "training" not in sys.modules and ref not in sys.path
    return src, ref, nets


def test_nvlabs_pkl_command_writes_what_the_jax_tool_writes(
        tool, nvlabs_pkl, tmp_path, monkeypatch):
    """nvlabs --reference-path: the npz of tools/convert_weights.py's
    convert_nvlabs_pkl on the same pickle, key for key and bit for bit,
    with an equal __config__; the port puts sys.path back and drops the
    checkout's modules."""
    src, ref, nets = nvlabs_pkl
    want, got = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    with monkeypatch.context() as m:
        m.setattr(sys, "path", list(sys.path))     # the tool leaves it in
        tool.convert_nvlabs_pkl(src, want, ref)
    for name in [k for k in sys.modules
                 if k == "training" or k.startswith("training.")]:
        del sys.modules[name]
    path = list(sys.path)
    tcw.main(["nvlabs", "--src", src, "--dest", got, "--reference-path",
              ref])
    assert sys.path == path and "training" not in sys.modules
    with np.load(want) as w, np.load(got) as g:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        config = json.loads(bytes(g["__config__"]).decode())
    assert config == {"g_cfg": {"z_dim": 16, "c_dim": 0, "w_dim": 16,
                                "img_resolution": 16, "img_channels": 3}}
    kept = sum(1 for sd in nets.values() for k in sd if tcw._keep(k))
    assert len(w.files) == kept + 1


def test_nvlabs_pkl_without_reference_path_names_the_flag(nvlabs_pkl,
                                                          tmp_path):
    src, _, _ = nvlabs_pkl
    with pytest.raises(ValueError, match="--reference-path"):
        tcw.main(["nvlabs", "--src", src, "--dest",
                  str(tmp_path / "x.npz")])


def test_nvlabs_pkl_route_imports_no_jax(nvlabs_pkl, tmp_path):
    """The command on the pickle, in a process with JAX and the JAX package
    blocked: it converts, and neither is imported."""
    src, ref, _ = nvlabs_pkl
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['gagan_tpu'] = None\n"
            "from gagan_tpu_torch.cli import convert_weights as c\n"
            f"c.main(['nvlabs', '--src', {src!r}, '--dest', "
            f"{str(tmp_path / 'y.npz')!r}, '--reference-path', {ref!r}])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gagan_tpu') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert os.path.exists(tmp_path / "y.npz")


# ----------------------------------------------------------------------------
# rosinality


def _rosinality_sd(seed, size=16, n_mlp=2, ch=8):
    """A rosinality Generator state dict: a 512-wide mapping of n_mlp
    layers (the command's config) and a narrow synthesis (the conversion
    copies it by name, whatever its width)."""
    rng = np.random.RandomState(seed)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    sd = {}
    for i in range(n_mlp):
        sd[f"style.{i + 1}.weight"] = r(512, 512) * 100
        sd[f"style.{i + 1}.bias"] = r(512)
    sd["input.input"] = r(1, ch, 4, 4)

    def conv(prefix, noise_res):
        sd[f"{prefix}.conv.weight"] = r(1, ch, ch, 3, 3)
        sd[f"{prefix}.conv.modulation.weight"] = r(ch, 512)
        sd[f"{prefix}.conv.modulation.bias"] = r(ch)
        sd[f"{prefix}.noise.weight"] = r(1)
        sd[f"{prefix}.activate.bias"] = r(ch)
        return r(1, 1, noise_res, noise_res)

    def rgb(prefix):
        sd[f"{prefix}.conv.weight"] = r(1, 3, ch, 1, 1)
        sd[f"{prefix}.conv.modulation.weight"] = r(ch, 512)
        sd[f"{prefix}.conv.modulation.bias"] = r(ch)
        sd[f"{prefix}.bias"] = r(1, 3, 1, 1)

    sd["noises.noise_0"] = conv("conv1", 4)
    rgb("to_rgb1")
    idx = 1
    for b, res in enumerate(2 ** i for i in range(3, int(np.log2(size)) + 1)):
        sd[f"noises.noise_{idx}"] = conv(f"convs.{2 * b}", res)
        sd[f"noises.noise_{idx + 1}"] = conv(f"convs.{2 * b + 1}", res)
        rgb(f"to_rgbs.{b}")
        idx += 2
    return sd


@pytest.mark.parametrize("size", [8, 32])
def test_rosinality_to_flat_matches_the_tool(tool, size):
    sd = _rosinality_sd(size, size=size, n_mlp=3)
    want = tool.rosinality_to_flat(sd, size, n_mlp=3)
    got = tcw.rosinality_to_flat(sd, size, n_mlp=3)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)
    assert tcw.rosinality_config(size, 2, 3) == {"g_cfg": {
        "z_dim": 512, "c_dim": 0, "w_dim": 512, "img_resolution": size,
        "img_channels": 3,
        "mapping": {"num_layers": 3, "lr_multiplier": 0.01},
        "synthesis": {"channel_base": 32768, "channel_max": 512}}}


@pytest.mark.parametrize("wrapped", [True, False])
def test_rosinality_command_writes_what_jax_loads(tool, tmp_path, wrapped):
    """rosinality: the size from the largest noise buffer, G_ema only, and
    w_avg the mean of the mapping net over the latents, as the JAX tool
    computes it (:122-134) on the same latents."""
    import argparse

    sd = _rosinality_sd(7)
    src, dest = str(tmp_path / "r.pt"), str(tmp_path / "r.npz")
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save({"g_ema": tsd, "args": argparse.Namespace(size=16)}
               if wrapped else tsd, src)
    z = np.random.RandomState(8).randn(64, 512).astype(np.float32)
    tcw.convert_rosinality(src, dest, n_mlp=2, device="cpu",
                           z=torch.from_numpy(z))
    trees, config = jck.load_snapshot(dest)
    assert sorted(trees) == ["G_ema"]
    assert config == tcw.rosinality_config(16, 2, 2)
    want = tool.rosinality_to_flat(sd, 16, n_mlp=2)
    g_cfg = jconfig.generator_config_from_dict(config["g_cfg"])
    params = jck.flat_to_tree(want)
    w_avg = np.asarray(jsg.mapping_apply(g_cfg.mapping, params["mapping"],
                                         jnp.asarray(z), broadcast=False
                                         ).mean(axis=0))
    got = jck.tree_to_flat(trees["G_ema"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "mapping.w_avg":
            np.testing.assert_allclose(np.asarray(got[k]), w_avg, rtol=0,
                                       atol=2e-4 * np.abs(w_avg).max())
            assert np.abs(w_avg).max() > 0
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)
    # The command line: its own 4096 latents (torch seed 0).
    dest2 = str(tmp_path / "r2.npz")
    tcw.main(["rosinality", "--src", src, "--dest", dest2, "--n-mlp", "2",
              "--size", "16", "--device", "cpu"])
    trees2, _ = tck.load_snapshot(dest2)
    w2 = trees2["G_ema"]["mapping"]["w_avg"].numpy()
    assert w2.shape == (512,) and np.isfinite(w2).all()
    assert not np.array_equal(w2, np.asarray(got["mapping.w_avg"]))


# ----------------------------------------------------------------------------
# CLIP


def _hf_clip_sd(seed=0, width=16, layers=2, vocab=20, ctx=7, patches=4):
    rng = np.random.RandomState(seed)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    sd = {}
    for tower, w in (("vision_model", width), ("text_model", width // 2)):
        for i in range(layers):
            p = f"{tower}.encoder.layers.{i}"
            for q in "qkv":
                sd[f"{p}.self_attn.{q}_proj.weight"] = r(w, w)
                sd[f"{p}.self_attn.{q}_proj.bias"] = r(w)
            sd[f"{p}.self_attn.out_proj.weight"] = r(w, w)
            sd[f"{p}.self_attn.out_proj.bias"] = r(w)
            for n in ("layer_norm1", "layer_norm2"):
                sd[f"{p}.{n}.weight"] = r(w)
                sd[f"{p}.{n}.bias"] = r(w)
            sd[f"{p}.mlp.fc1.weight"] = r(4 * w, w)
            sd[f"{p}.mlp.fc1.bias"] = r(4 * w)
            sd[f"{p}.mlp.fc2.weight"] = r(w, 4 * w)
            sd[f"{p}.mlp.fc2.bias"] = r(w)
    sd["vision_model.embeddings.patch_embedding.weight"] = r(width, 3, 8, 8)
    sd["vision_model.embeddings.class_embedding"] = r(width)
    sd["vision_model.embeddings.position_embedding.weight"] = r(
        patches + 1, width)
    for n in ("pre_layrnorm", "post_layernorm"):
        sd[f"vision_model.{n}.weight"] = r(width)
        sd[f"vision_model.{n}.bias"] = r(width)
    sd["visual_projection.weight"] = r(8, width)
    sd["text_model.embeddings.token_embedding.weight"] = r(vocab, width // 2)
    sd["text_model.embeddings.position_embedding.weight"] = r(ctx, width // 2)
    sd["text_model.final_layer_norm.weight"] = r(width // 2)
    sd["text_model.final_layer_norm.bias"] = r(width // 2)
    sd["text_projection.weight"] = r(8, width // 2)
    sd["logit_scale"] = np.float32(2.6592)
    sd["text_model.embeddings.position_ids"] = np.arange(ctx)[None]
    return sd


def _openai_clip_sd(seed=1):
    from gagan_tpu.clip import model as jclip

    ccfg = jclip.CLIPConfig(embed_dim=8, image_resolution=16, vision_layers=1,
                            vision_width=16, vision_patch_size=8,
                            context_length=7, vocab_size=20,
                            transformer_width=8, transformer_heads=2,
                            transformer_layers=1, vision_heads_override=2)
    sd = {k: np.asarray(v) for k, v in jck.tree_to_flat(
        jclip.init_clip(jax.random.PRNGKey(seed), ccfg)).items()}
    sd.update(input_resolution=np.int64(16), input_resolution_text=np.int64(7),
              context_length=np.int64(7), vocab_size=np.int64(20))
    return sd


def test_clip_state_dicts_match_jax():
    hf = _hf_clip_sd()
    _same_trees(tconv.from_hf_state_dict({k: torch.from_numpy(np.asarray(v))
                                          for k, v in hf.items()}),
                jconv.from_hf_state_dict(hf))
    oa = _openai_clip_sd()
    got = tconv.from_openai_state_dict(oa)
    _same_trees(got, jconv.from_openai_state_dict(oa))
    assert "input_resolution" not in got and "context_length" in got


@pytest.mark.parametrize("kind", ["hf-clip", "openai-clip"])
def test_clip_commands_write_what_jax_loads(kind, tmp_path):
    """hf-clip reads a pytorch_model.bin state dict, openai-clip a state
    dict .pt (the TorchScript archive path falls back to it): the npz is
    the JAX function's tree, flattened as GAGAN_CLIP_DIR files are."""
    sd = _hf_clip_sd(2) if kind == "hf-clip" else _openai_clip_sd(3)
    src = str(tmp_path / "src.bin")
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}, src)
    dest = str(tmp_path / "clip.npz")
    tcw.main([kind, "--src", src, "--dest", dest])
    want = jck.tree_to_flat((jconv.from_hf_state_dict if kind == "hf-clip"
                             else jconv.from_openai_state_dict)(sd))
    with np.load(dest) as data:
        got = {k: data[k] for k in data.files}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_reference_fault_rosinality_command_lacks_channel_multiplier(
        tool, monkeypatch, tmp_path):
    """A fault of tools/convert_weights.py: ``--channel-multiplier`` is
    registered under the ``lpips_alex`` subcommand only (`:447-451`), but
    ``rosinality`` reads it (`:456-458`), so the ``rosinality`` command
    stops with an AttributeError before it opens its source.  The port's
    command takes the option."""
    dest = str(tmp_path / "x.npz")
    monkeypatch.setattr("sys.argv", ["convert_weights.py", "rosinality",
                                     "--src", str(tmp_path / "none.pt"),
                                     "--dest", dest])
    with pytest.raises(AttributeError, match="channel_multiplier"):
        tool.main()
    args = tcw.build_parser().parse_args(
        ["rosinality", "--src", "a.pt", "--dest", dest,
         "--channel-multiplier", "1"])
    assert args.channel_multiplier == 1


# ----------------------------------------------------------------------------
# InceptionV3 and LPIPS-alex


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _same_npz(got, want):
    got, want = _npz(got), _npz(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_inception_command_matches_the_tool(tool, tmp_path):
    """A pytorch-fid-layout state dict (convs, batch norms with their
    num_batches_tracked, fc): the same npz as the JAX tool writes."""
    rng = np.random.default_rng(5)
    sd = {}
    for name, shape in (("Conv2d_1a_3x3", (32, 3, 3, 3)),
                        ("Mixed_7c.branch_pool", (192, 2048, 1, 1))):
        sd[f"{name}.conv.weight"] = torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32))
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{name}.bn.{leaf}"] = torch.from_numpy(
                rng.standard_normal(shape[0], dtype=np.float32))
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(7)
    sd["fc.weight"] = torch.from_numpy(rng.standard_normal(
        (1008, 2048), dtype=np.float32))
    sd["fc.bias"] = torch.from_numpy(rng.standard_normal(1008,
                                                         dtype=np.float32))
    src = str(tmp_path / "pt_inception.pth")
    torch.save(sd, src)
    want, got = str(tmp_path / "want.npz"), str(tmp_path / "got.npz")
    tool.convert_inception(src, want)
    tcw.main(["inception", "--src", src, "--dest", got])
    _same_npz(got, want)
    assert "Conv2d_1a_3x3.bn.num_batches_tracked" not in _npz(got)


def _lpips_alex_sds(seed):
    """(full LPIPS state dict, lin-only state dict, torchvision AlexNet
    state dict) of seeded values."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    slices = {0: 1, 3: 2, 6: 3, 8: 4, 10: 5}
    full, lins, tv = {}, {}, {}
    for idx, (cin, cout, k, _, _) in talex.ALEX_CONVS.items():
        w, b = r(cout, cin, k, k), r(cout)
        full[f"net.slice{slices[idx]}.{idx}.weight"] = w
        full[f"net.slice{slices[idx]}.{idx}.bias"] = b
        tv[f"features.{idx}.weight"], tv[f"features.{idx}.bias"] = w, b
    for i, c in enumerate(talex.LPIPS_CHANNELS):
        lins[f"lin{i}.model.1.weight"] = r(1, c, 1, 1).abs()
    full.update(lins)
    full["scaling_layer.shift"] = r(1, 3, 1, 1)
    full["scaling_layer.scale"] = r(1, 3, 1, 1)
    tv["classifier.1.weight"] = r(8, 4)
    return full, lins, tv


@pytest.mark.parametrize("layout", ["full", "lin-only"])
def test_lpips_alex_command_matches_the_tool(tool, tmp_path, layout):
    """lpips-alex: a full LPIPS(net='alex') state dict, or the lin-only
    file with --alexnet-src: the same npz as the JAX tool's lpips_alex, and
    metrics/alexnet.py::load_params reads it."""
    full, lins, tv = _lpips_alex_sds(6)
    src = str(tmp_path / "lpips.pth")
    torch.save(full if layout == "full" else lins, src)
    extra, alex = [], None
    if layout == "lin-only":
        alex = str(tmp_path / "alexnet.pth")
        torch.save(tv, alex)
        extra = ["--alexnet-src", alex]
    want, got = str(tmp_path / "want.npz"), str(tmp_path / "got.npz")
    tool.convert_lpips_alex(src, want, alex)
    tcw.main(["lpips-alex", "--src", src, "--dest", got] + extra)
    _same_npz(got, want)
    params = talex.load_params(got)
    assert params["lin"]["4"]["weight"].shape == (256,)
    assert ("scaling" in params) == (layout == "full")
    torch.save(lins, src)
    with pytest.raises(KeyError, match="AlexNet conv weights missing"):
        tcw.main(["lpips-alex", "--src", src, "--dest", got])


# ----------------------------------------------------------------------------
# ReStyle


def test_restyle_command_matches_the_tool(tool, tmp_path):
    """The restyle command on a torch.save'd checkpoint (encoder with BN
    num_batches_tracked, rosinality decoder, opts, a [512] latent_avg)
    writes the JAX tool's npz, array for array."""
    from .test_torch_restyle import restyle_checkpoint

    src = str(tmp_path / "restyle.pt")
    torch.save(restyle_checkpoint("ResNetProgressiveBackboneEncoder", 4, 16),
               src)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    tcw.main(["restyle", "--src", src, "--dest", ours])
    tool.convert_restyle(src, theirs)
    _same_npz(ours, theirs)
    assert "latent_avg" in _npz(ours)
