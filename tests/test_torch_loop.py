"""The port's training loop (gagan_tpu_torch.train.loop) against the JAX
package's (gagan_tpu.train.loop.training_loop): 3 batches at 16x16, batch 4
in rounds of 2, both reg phases (batch 0), ADA every 2 batches with the
"bgc" pipe (JAX's in its exact geometry), two ticks.  Both loops resume
from one JAX-written snapshot, read one folder of PNGs and draw JAX's
numbers (``JaxRng`` on the loop's key tree), so they run the same steps.

Tolerances are tests/test_torch_train_step.py's, over three steps: a
step moves each parameter by at most about lr * sqrt(t) at Adam step t
(beta1 = 0, bias-corrected second moment), and where a gradient is near
zero the two packages may move it in opposite directions, so each tree is
held to |port move - JAX move| <= 2 lr (1 + sqrt 2 + sqrt 3) + 1e-6 and
moves more than lr / 4 apart on at most 1% of the elements (a wrong
gradient flips about half of them).  Loss metrics: 1e-3 relative.

The other tests run the port alone: files written, resume, abort,
progress and metrics hooks, refusals, image grids against JAX's.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import PIL.Image
import pytest
import torch

from gagan_tpu.models import stylegan2 as jsg
from gagan_tpu.train import augment as jaug
from gagan_tpu.train import gan_loss as jgl
from gagan_tpu.train import loop as jloop
from gagan_tpu.train import train_step as jts
from gagan_tpu.utils import checkpoint as jck
from gagan_tpu.utils import config as jconfig
from gagan_tpu_torch.data import ImageFolderDataset
from gagan_tpu_torch.models import stylegan2 as tsg
from gagan_tpu_torch.train import augment as taug
from gagan_tpu_torch.train import gan_loss as tgl
from gagan_tpu_torch.train import loop as tloop
from gagan_tpu_torch.train import train_step as tts
from gagan_tpu_torch.utils import checkpoint as tck
from gagan_tpu_torch.utils.png import read_png

from .test_torch_augment import JaxRng

torch.set_num_threads(2)

RES, BATCH = 16, 4


def _cfgs(m):
    g = m.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=RES,
        mapping=m.MappingConfig(num_layers=2),
        synthesis=m.SynthesisConfig(channel_base=256, channel_max=32))
    d = m.DiscriminatorConfig(img_resolution=RES, channel_base=256,
                              channel_max=32, mbstd_group_size=2)
    return g, d


def _train_cfg(m, gl):
    return m.TrainConfig(
        batch_size=BATCH, g_lr=0.002, d_lr=0.002, ema_kimg=0.1,
        ada_target=0.6, ada_interval=2, accum_rounds=2,
        loss=gl.GANLossConfig(r1_gamma=0.5))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    for i in range(10):
        PIL.Image.fromarray(rng.randint(0, 256, (RES, RES, 3), np.uint8)).save(
            d / f"img{i:03d}.png")
    return str(d)


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    """JAX-initialised G, D and a G_ema a little apart from G, with noise
    strengths and biases non-zero."""
    jg, jd = _cfgs(jsg)
    rng = np.random.RandomState(3)
    flats = []
    for tree in (jsg.init_generator(jax.random.PRNGKey(1), jg),
                 jsg.init_discriminator(jax.random.PRNGKey(2), jd)):
        flat = jck.tree_to_flat(tree)
        for k, v in flat.items():
            if k.endswith("noise_strength"):
                flat[k] = np.float32(rng.uniform(0.1, 0.3))
            elif k.endswith(".bias") and ".affine." not in k:
                flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        flats.append(flat)
    g, d = flats
    ema = {k: (v + 0.01 * np.asarray(rng.randn(*np.shape(v)), np.float32)
               if k.startswith("synthesis") else v) for k, v in g.items()}
    path = str(tmp_path_factory.mktemp("snap") / "jax.npz")
    jck.save_snapshot(path, g_params=jck.flat_to_tree(g),
                      d_params=jck.flat_to_tree(d), g_ema=jck.flat_to_tree(ema),
                      config={"g_cfg": jconfig.to_dict(jg),
                              "d_cfg": jconfig.to_dict(jd)})
    return path, g, d, ema


def _loop_cfg(m, run_dir, **kw):
    base = dict(run_dir=run_dir, total_kimg=0.012, kimg_per_tick=0.008,
                image_snapshot_ticks=1, network_snapshot_ticks=1,
                random_seed=5, grid_size=(2, 2), log_param_histograms=False,
                initial_ada_p=0.4)
    base.update(kw)
    return m.LoopConfig(**base)


def _stats(run_dir):
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _check_moves(name, before, got, want, lr, steps=3):
    bound = 2 * lr * sum(np.sqrt(t) for t in range(1, steps + 1)) + 1e-6
    moved_far = total = 0
    for k, w in want.items():
        d = (got[k] - before[k]) - (w - before[k])
        assert np.abs(d).max() <= bound, (name, k, np.abs(d).max(), bound)
        moved_far += int((np.abs(d) > lr / 4).sum())
        total += d.size
    assert moved_far <= 0.01 * total, (name, moved_far, total)


@pytest.mark.slow          # about 70 s on the CPU, most of it JAX's jit
def test_loop_matches_jax(data_dir, jax_snapshot, tmp_path):
    _loop_parity(data_dir, jax_snapshot, tmp_path)


# The few-shot Affine+ protocol at 16^2: G's affines and the b8 weight
# offsets train (the b64 of the 1024^2 protocol).
OFFSETS_PARTS = ("synt_affine", "tRGB_affine", "synt_weights_offset.b8",
                 "tRGB_weights_offset.b8")


@pytest.mark.slow          # about 70 s on the CPU, most of it JAX's jit
def test_loop_with_offsets_matches_jax(data_dir, jax_snapshot, tmp_path):
    """The loop's parametrization branch: the offsets' key, optimizer and
    EMA, and the adaptation files, against the JAX loop's."""
    _loop_parity(data_dir, jax_snapshot, tmp_path,
                 parametrization="out_in_additive", parts=OFFSETS_PARTS)


def _loop_parity(data_dir, jax_snapshot, tmp_path, parametrization=None,
                 parts=("all",)):
    path, g0, d0, ema0 = jax_snapshot
    jg, jd = _cfgs(jsg)
    tg, td = _cfgs(tsg)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jaug_cfg = dataclasses.replace(jaug.make_config("bgc"), geom_mode="exact")
    jtrain = dataclasses.replace(_train_cfg(jts, jgl),
                                 g_requires_grad_parts=parts)
    ttrain = dataclasses.replace(_train_cfg(tts, tgl),
                                 g_requires_grad_parts=parts)
    jstate = jloop.training_loop(
        _loop_cfg(jloop, jdir, resume_from=path, n_devices=1), jtrain, jg, jd,
        jloop.ImageFolderDataset(data_dir), augment_cfg=jaug_cfg,
        parametrization=parametrization, weight_parts=parts)
    state = tloop.training_loop(
        _loop_cfg(tloop, tdir, resume_from=path), ttrain, tg,
        td, ImageFolderDataset(data_dir),
        augment_cfg=dataclasses.replace(taug.make_config("bgc"),
                                        geom_mode="exact"), device="cpu",
        rng=JaxRng(jax.random.PRNGKey(5)), parametrization=parametrization,
        weight_parts=parts)

    assert state.cur_nimg == int(jstate.cur_nimg) == 12
    assert float(state.ada_p) == pytest.approx(float(jstate.ada_p), abs=1e-7)
    assert float(state.ada_p) != 0.4                 # ADA adjusted p
    np.testing.assert_allclose(float(state.pl_mean), float(jstate.pl_mean),
                               rtol=1e-3, atol=1e-7)
    g_tx, d_tx, _, _ = tts.build_optimizers(ttrain, tck.flat_to_tree(g0),
                                            tck.flat_to_tree(d0))
    trees = [("G", state.g_params, jstate.g_params, g0, g_tx.lr),
             ("D", state.d_params, jstate.d_params, d0, d_tx.lr),
             ("G_ema", state.g_ema, jstate.g_ema, ema0, g_tx.lr)]
    if parametrization:
        off0 = {k: np.zeros_like(np.asarray(v)) for k, v in
                jck.tree_to_flat(jstate.offsets).items()}
        assert sorted(state.offsets) == ["b8.conv0", "b8.conv1", "b8.torgb"]
        # The offsets step in Gmain and again in Greg: 4 Adam steps in 3
        # batches (Greg on batch 0), each at most lr.
        trees += [("offsets", state.offsets, jstate.offsets, off0,
                   ttrain.g_lr * 2),
                  ("offsets_ema", state.offsets_ema, jstate.offsets_ema, off0,
                   ttrain.g_lr * 2)]
        assert state.offsets_opt_state.count == 4
        assert max(float(np.abs(v).max()) for v in
                   tck.tree_to_flat(state.offsets).values()) > 0
    for name, got, want, before, step_lr in trees:
        _check_moves(name, before, tck.tree_to_flat(got),
                     {k: np.asarray(v) for k, v in
                      jck.tree_to_flat(want).items()}, step_lr)

    got, want = _stats(tdir), _stats(jdir)
    assert len(got) == len(want) == 2
    for g_line, j_line in zip(got, want):
        assert set(g_line) == set(j_line)
        for k, v in j_line.items():
            if k.startswith(("Loss/", "Progress/")):
                np.testing.assert_allclose(g_line[k], v, rtol=1e-3, atol=1e-3,
                                           err_msg=k)
    assert [ln["Progress/kimg"] for ln in got] == [0.008, 0.012]
    def files(d):
        return sorted(f for f in os.listdir(d)
                      if not f.startswith("events.out"))

    assert files(tdir) == files(jdir)
    if parametrization:
        assert "adaptation-000000.npz" in files(tdir)
        jmeta, _, _ = jck.load_adaptation(os.path.join(
            jdir, "adaptation-000000.npz"))
        tmeta, toff, _ = jck.load_adaptation(os.path.join(
            tdir, "adaptation-000000.npz"))
        assert tmeta == jmeta
        np.testing.assert_array_equal(
            np.asarray(toff["b8.conv0"]["weights_offset"]),
            tck.tree_to_flat(state.offsets_ema)["b8.conv0.weights_offset"])


def test_loop_writes_what_jax_reads(data_dir, tmp_path):
    """stats.jsonl, the image grid (a 2x2 grid of 16x16 images), a snapshot
    that the JAX package loads and configures from, training_options.json,
    the progress and metrics hooks."""
    run = str(tmp_path / "run")
    progress, metrics = [], []
    tg, td = _cfgs(tsg)
    state = tloop.training_loop(
        _loop_cfg(tloop, run, log_param_histograms=True,
                  progress_fn=lambda k, t: progress.append((k, t)),
                  metrics_fn=lambda g, cfg, snapshot: metrics.append(
                      (sorted(g), cfg, os.path.basename(snapshot)))),
        _train_cfg(tts, tgl), tg, td, ImageFolderDataset(data_dir),
        augment_cfg=taug.make_config("bgc"), device="cpu")
    files = sorted(os.listdir(run))
    assert {"stats.jsonl", "training_options.json", "fakes000000.png",
            "network-snapshot-000000.npz"} <= set(files)
    lines = _stats(run)
    assert len(lines) == 2 and all(np.isfinite(v) for ln in lines
                                   for v in ln.values())
    for k in ("Loss/G/loss", "Loss/D/loss", "Loss/signs/real",
              "Loss/r1_penalty", "Loss/pl_penalty", "Timing/sec_per_kimg"):
        assert k in lines[0] or k in lines[1], k
    grid = read_png(os.path.join(run, "fakes000000.png"))
    assert grid.shape == (32, 32, 3) and grid.std() > 0
    trees, cfg = jck.load_snapshot(os.path.join(run,
                                                "network-snapshot-000000.npz"))
    assert jconfig.generator_config_from_dict(cfg["g_cfg"]) == _cfgs(jsg)[0]
    assert jconfig.discriminator_config_from_dict(cfg["d_cfg"]) == _cfgs(jsg)[1]
    assert set(jck.tree_to_flat(trees["G"])) == set(tck.tree_to_flat(
        state.g_params))
    assert int(trees["extra"]["cur_nimg"]) == 12
    assert progress == [(0, 0.012), (0, 0.012)]
    assert [m[2] for m in metrics] == ["network-snapshot-000000.npz"] * 2
    assert metrics[0][1] == tg and "mapping" in metrics[0][0]
    with open(os.path.join(run, "training_options.json")) as f:
        opts = json.load(f)
    assert opts["train"]["batch_size"] == "4" and "loop" in opts


def test_loop_resumes_and_aborts(data_dir, jax_snapshot, tmp_path):
    """Resume copies G, D and G_ema by name (a shape mismatch is skipped);
    abort_fn ends the run at the first tick."""
    path, g0, _, _ = jax_snapshot
    tg, td = _cfgs(tsg)
    seen = []

    def metrics_fn(g_ema, cfg, snapshot):
        seen.append(tck.tree_to_flat(g_ema))

    state = tloop.training_loop(
        _loop_cfg(tloop, str(tmp_path / "r"), resume_from=path,
                  total_kimg=1.0, abort_fn=lambda: True,
                  metrics_fn=metrics_fn),
        _train_cfg(tts, tgl), tg, td, ImageFolderDataset(data_dir),
        device="cpu")
    assert state.cur_nimg == 8                      # one tick of 8 images
    got = tck.tree_to_flat(state.g_params)
    a, b = got["synthesis.b4.conv1.weight"], g0["synthesis.b4.conv1.weight"]
    assert not np.array_equal(a, b)
    assert np.abs(a - b).max() <= 2 * 0.002 * 2     # two Adam steps
    assert len(seen) == 1

    wide = dataclasses.replace(tg, synthesis=dataclasses.replace(
        tg.synthesis, channel_base=512, channel_max=64))
    state = tloop.training_loop(
        _loop_cfg(tloop, str(tmp_path / "w"), resume_from=path,
                  total_kimg=0.004, image_snapshot_ticks=None,
                  network_snapshot_ticks=None),
        _train_cfg(tts, tgl), wide, td, ImageFolderDataset(data_dir),
        device="cpu")
    assert state.g_params["synthesis"]["b4"]["const"].shape[0] == 64


@pytest.mark.parametrize("kw,match", [
    ({"spatial_shard_min_res": 64}, "item 10"),
    ({"n_devices": 2}, "item 10")])
def test_loop_refuses_unported_options(kw, match, data_dir, tmp_path):
    """Both options, refused while the port trained on one card, now run.
    ``n_devices=2`` trains over two ranks (:func:`_check_two_rank_loop`);
    outside a process group it asks for the ranks to be started.
    ``spatial_shard_min_res`` does nothing in a world of one, as in JAX:
    the run equals the plain one (test_torch_cli_train.py runs it over two
    ranks, tests/test_torch_spatial.py holds the sharded step)."""
    tg, td = _cfgs(tsg)
    dataset = ImageFolderDataset(data_dir)
    if "n_devices" in kw:
        with pytest.raises(ValueError, match="spawn"):
            tloop.training_loop(_loop_cfg(tloop, str(tmp_path), **kw),
                                _train_cfg(tts, tgl), tg, td, dataset,
                                device="cpu")
        _check_two_rank_loop(data_dir, tmp_path)
        return
    short = dict(total_kimg=0.004, image_snapshot_ticks=None,
                 network_snapshot_ticks=None)
    states = [tloop.training_loop(
        _loop_cfg(tloop, str(tmp_path / name), **short),
        _train_cfg(tts, tgl), tg, td, dataset, device="cpu", **extra)
        for name, extra in (("plain", {}), ("spatial", kw))]
    a, b = (tck.tree_to_flat_tensors(s.g_params) for s in states)
    assert all(torch.equal(a[k], b[k]) for k in a)


def _check_two_rank_loop(data_dir, tmp_path):
    """The loop over two gloo ranks (3 batches of 4 in rounds of 2, so one
    image a rank a round and mbstd groups across ranks; ADA with the fast
    warp) against the one-process loop on the same folder: only rank 0
    wrote files, the same ones as the one-process loop;
    stats.jsonl holds the same global values (the loss metrics and ADA's
    p within the step tolerance of the module docstring, 1e-3 relative);
    each rank's loader reads its rows of the one-process batches, in
    order."""
    from gagan_tpu_torch.data.dataset import data_loader
    from gagan_tpu_torch.parallel import dryrun
    from gagan_tpu_torch.parallel import mesh as tmesh

    tg, td = _cfgs(tsg)
    cfg = _train_cfg(tts, tgl)
    aug = taug.make_config("bgc")
    one_dir = str(tmp_path / "one")
    tloop.training_loop(_loop_cfg(tloop, one_dir), cfg, tg, td,
                        ImageFolderDataset(data_dir), augment_cfg=aug,
                        device="cpu")
    ranks = tmesh.spawn(dryrun.loop_rank, 2, devices="cpu", timeout=120,
                        limit=120, args=(_loop_cfg(
                            tloop, str(tmp_path / "dp"), n_devices=2), cfg,
                            tg, td, data_dir, aug))
    def named(files):        # TensorBoard names its file by time and pid
        return [f for f in files if not f.startswith("events.out")]

    assert ranks[1]["files"] == [] and named(ranks[0]["files"]) == named(
        sorted(os.listdir(one_dir)))
    assert "network-snapshot-000000.npz" in ranks[0]["files"]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    want, got = _stats(one_dir), _stats(str(tmp_path / "dp" / "rank0"))
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k, v in w.items():
            if k.startswith(("Loss/", "Progress/")):
                np.testing.assert_allclose(g[k], v, rtol=1e-3, atol=1e-6,
                                           err_msg=k)

    rounds = tts.data_rounds(cfg)
    loaders = [data_loader(ImageFolderDataset(data_dir), BATCH, seed=5,
                           num_workers=1, rows=tmesh.share_rows(
                               BATCH, 2, r, rounds)) for r in range(2)]
    whole = data_loader(ImageFolderDataset(data_dir), BATCH, seed=5,
                        num_workers=1)
    try:
        for _ in range(4):
            want_imgs, _ = next(whole)
            shares = [next(it)[0] for it in loaders]
            for r, share in enumerate(shares):
                np.testing.assert_array_equal(
                    share, want_imgs[tmesh.share_rows(BATCH, 2, r, rounds)])
    finally:
        for it in loaders + [whole]:
            it.close()


def test_loop_reads_a_native_zip_as_the_folder_reader(data_dir, tmp_path):
    """A NativeZipDataset (the C++ batch decoder) trains the loop to the
    same state as an ImageFolderDataset of the same zip: the same images in
    the same order.  Skips where the library does not build."""
    from gagan_tpu_torch.data import dataset_tool, native_loader

    if not native_loader.native_available():
        pytest.skip(f"native loader: {native_loader.build_error()}")
    data = str(tmp_path / "data.zip")
    dataset_tool.convert_dataset(data_dir, data)
    tg, td = _cfgs(tsg)
    states = []
    for name, ds in (("native", native_loader.NativeZipDataset(data)),
                     ("folder", ImageFolderDataset(data))):
        states.append(tloop.training_loop(
            _loop_cfg(tloop, str(tmp_path / name), total_kimg=0.004,
                      image_snapshot_ticks=None, network_snapshot_ticks=None),
            _train_cfg(tts, tgl), tg, td, ds, device="cpu"))
    a, b = (tck.tree_to_flat_tensors(s.g_params) for s in states)
    assert states[0].cur_nimg == states[1].cur_nimg > 0
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_loop_refuses_cpu_fallback(data_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tg, td = _cfgs(tsg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.training_loop(_loop_cfg(tloop, str(tmp_path)),
                            _train_cfg(tts, tgl), tg, td,
                            ImageFolderDataset(data_dir))


@pytest.mark.parametrize("channels", [1, 3])
def test_save_image_grid_matches_jax(channels, tmp_path):
    img = np.random.RandomState(channels).uniform(
        -1.2, 1.2, (6, channels, 5, 7)).astype(np.float32)
    tloop.save_image_grid(img, str(tmp_path / "t.png"), [-1, 1], (3, 2))
    jloop.save_image_grid(img, str(tmp_path / "j.png"), [-1, 1], (3, 2))
    want = np.array(PIL.Image.open(tmp_path / "j.png"))
    got = read_png(str(tmp_path / "t.png"))
    assert got.shape == want.shape == ((10, 21) if channels == 1
                                       else (10, 21, 3))
    np.testing.assert_array_equal(got, want)


def test_loop_config_fields_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jloop.LoopConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tloop.LoopConfig)]
    assert tf == jf
