"""The port stands alone: nothing in gagan_tpu_torch/ or chip_smoke.py imports
JAX or the JAX package, the port imports with JAX blocked, and its CUDA
entry points refuse to run (rather than fall back) without a CUDA device."""

import ast
import os
import re
import subprocess
import sys

import numpy as np
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
            "gagan_tpu_torch.utils.config, gagan_tpu_torch.params.offsets, "
            "gagan_tpu_torch.clip, gagan_tpu_torch.clip.model, "
            "gagan_tpu_torch.clip.tokenizer, gagan_tpu_torch.ops.resize, "
            "gagan_tpu_torch.train.adapt_losses, "
            "gagan_tpu_torch.train.adaptation, gagan_tpu_torch.cli.adapt, "
            "gagan_tpu_torch.inference, gagan_tpu_torch.utils.yaml_subset, "
            "gagan_tpu_torch.utils.text_templates, "
            "gagan_tpu_torch.utils.torch_import, gagan_tpu_torch.clip.convert, "
            "gagan_tpu_torch.cli.convert_weights, "
            "gagan_tpu_torch.params.sparse, gagan_tpu_torch.params.mappers, "
            "gagan_tpu_torch.train.auto_layers, gagan_tpu_torch.metrics.vgg16, "
            "gagan_tpu_torch.metrics.detectors, gagan_tpu_torch.inversion, "
            "gagan_tpu_torch.inversion.encoders, "
            "gagan_tpu_torch.inversion.projector, "
            "gagan_tpu_torch.cli.projector, gagan_tpu_torch.models.swin, "
            "gagan_tpu_torch.ga.search, gagan_tpu_torch.ga.evaluation, "
            "gagan_tpu_torch.metrics, gagan_tpu_torch.metrics.alexnet, "
            "gagan_tpu_torch.metrics.inception, "
            "gagan_tpu_torch.metrics.feature_stats, "
            "gagan_tpu_torch.metrics.fid, gagan_tpu_torch.metrics.kid, "
            "gagan_tpu_torch.metrics.precision_recall, "
            "gagan_tpu_torch.metrics.inception_score, "
            "gagan_tpu_torch.metrics.ppl, gagan_tpu_torch.metrics.clip_eval, "
            "gagan_tpu_torch.metrics.metric_main, "
            "gagan_tpu_torch.cli.calc_metrics, "
            "gagan_tpu_torch.inversion.restyle, gagan_tpu_torch.inversion.ii2s, "
            "gagan_tpu_torch.inversion.e4e_training, gagan_tpu_torch.editing, "
            "gagan_tpu_torch.editing.interfacegan, "
            "gagan_tpu_torch.editing.stylespace, "
            "gagan_tpu_torch.editing.styleflow, gagan_tpu_torch.train.warp, "
            "gagan_tpu_torch.face, gagan_tpu_torch.face.align, "
            "gagan_tpu_torch.face.mtcnn, gagan_tpu_torch.data.style_dataset, "
            "gagan_tpu_torch.data.lmdb_reader, "
            "gagan_tpu_torch.data.dataset_tool, "
            "gagan_tpu_torch.data.native_loader\n"
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


def test_port_imports_with_pil_and_click_blocked(tmp_path):
    """The card's machine has neither Pillow, cv2, click nor lmdb: every
    module of the port imports without them (and without JAX), and the
    real-image paths run with them blocked, on the CPU: the random MTCNN
    cascade, align_face_auto (from fixed landmarks: random nets give
    degenerate ones), the cv2-free warp-crop, ImagesDataset on a PNG and
    the dataset tool on a PNG folder."""
    mods = _port_modules()
    assert {"gagan_tpu_torch.train.loop", "gagan_tpu_torch.cli.train",
            "gagan_tpu_torch.cli.style_mixing", "gagan_tpu_torch.data.dataset",
            "gagan_tpu_torch.utils.png", "gagan_tpu_torch.utils.stats",
            "gagan_tpu_torch.utils.observability",
            "gagan_tpu_torch.utils.registry", "gagan_tpu_torch.train.warp",
            "gagan_tpu_torch.face", "gagan_tpu_torch.face.align",
            "gagan_tpu_torch.face.mtcnn", "gagan_tpu_torch.data.style_dataset",
            "gagan_tpu_torch.data.lmdb_reader",
            "gagan_tpu_torch.data.dataset_tool",
            "gagan_tpu_torch.data.native_loader"} <= set(mods)
    rng = np.random.RandomState(1)
    src = tmp_path / "src"
    src.mkdir()
    from gagan_tpu_torch.utils.png import write_png
    for i in range(2):
        img = np.repeat(np.repeat(rng.randint(0, 256, (12, 12, 3)), 8, 0),
                        8, 1).astype(np.uint8)
        write_png(str(src / f"im{i}.png"), img, filter_type=4)
    code = ("import importlib, sys\n"
            "for m in ('PIL', 'click', 'cv2', 'lmdb', 'jax', 'gagan_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "assert 'triton' not in sys.modules\n"
            "import numpy as np\n"
            "from gagan_tpu_torch.face import align, mtcnn\n"
            "from gagan_tpu_torch.data import dataset_tool, style_dataset\n"
            "from gagan_tpu_torch.data.dataset import read_rgb\n"
            f"img = read_rgb({str(src / 'im0.png')!r})\n"
            "net = mtcnn.MTCNN(device='cpu')\n"
            "boxes, lms = net.detect_faces(img)\n"
            "lm = np.array([[30., 40.], [60., 40.], [45., 55.], [34., 70.],"
            " [58., 70.]])\n"
            "face = align.align_face_5p(img, lm, output_size=32,"
            " transform_size=64, device='cpu')\n"
            "assert face.shape == (32, 32, 3)\n"
            "class Fixed:\n"
            "    def detect_faces(self, image):\n"
            "        return (np.array([[20., 30., 70., 80., 0.9]]),"
            " np.concatenate([lm[:, 0], lm[:, 1]])[None])\n"
            "out = align.align_face_auto(img, output_size=32,"
            " transform_size=64, mtcnn=Fixed(), device='cpu')\n"
            "assert out.shape == (32, 32, 3)\n"
            "crop, _ = align.warp_and_crop_face(img, lm, net.reference,"
            " (112, 112))\n"
            "assert crop.shape == (112, 112, 3)\n"
            f"ds = style_dataset.ImagesDataset(64, {str(src)!r})\n"
            "assert ds[1]['image_low_res'].shape == (256, 256, 3)\n"
            f"dataset_tool.main(['--source', {str(src)!r}, '--dest',"
            f" {str(tmp_path / 'out.zip')!r}, '--width', '32',"
            " '--height', '32'])\n"
            "assert 'PIL' not in [k for k, v in sys.modules.items()"
            " if v is not None]\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    import zipfile
    with zipfile.ZipFile(tmp_path / "out.zip") as z:
        assert sorted(z.namelist()) == ["00000/img00000000.png",
                                        "00000/img00000001.png",
                                        "dataset.json"]


def test_adaptation_runs_without_yaml_regex_or_ftfy(tmp_path):
    """The card's machine is not assumed to have PyYAML, regex or ftfy:
    with them (and JAX, Pillow, click) blocked, every module imports, the
    tokenizer encodes, the YAML subset reads every config and the adapt
    command runs a tiny config on the CPU."""
    mods = _port_modules()
    assert {"gagan_tpu_torch.params.offsets", "gagan_tpu_torch.clip.model",
            "gagan_tpu_torch.clip.tokenizer", "gagan_tpu_torch.ops.resize",
            "gagan_tpu_torch.train.adapt_losses",
            "gagan_tpu_torch.train.adaptation", "gagan_tpu_torch.cli.adapt",
            "gagan_tpu_torch.inference", "gagan_tpu_torch.utils.yaml_subset",
            "gagan_tpu_torch.utils.text_templates"} <= set(mods)
    code = ("import glob, importlib, sys\n"
            "for m in ('yaml', 'regex', 'ftfy', 'PIL', 'click', 'jax', "
            "'gagan_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from gagan_tpu_torch.clip.tokenizer import SimpleTokenizer\n"
            "from gagan_tpu_torch.utils import yaml_subset\n"
            "from gagan_tpu_torch.cli import adapt\n"
            "from gagan_tpu_torch.entry import TINY_CLIP\n"
            "assert SimpleTokenizer().encode('a photo')\n"
            "for p in glob.glob('configs/*.yaml'):\n"
            "    yaml_subset.read(p)\n"
            "adapt.main(['--config', 'configs/td_nada_sdelta.yaml', "
            f"'--outdir', {str(tmp_path / 'run')!r}, '--device', 'cpu', "
            "'training.iter_num=1', 'training.batch_size=1', "
            "'training.img_resolution=8', 'training.generator_args="
            "{\"z_dim\": 8, \"w_dim\": 8, \"num_mapping_layers\": 1, "
            "\"channel_base\": 64, \"channel_max\": 16}', "
            "f'training.clip_config_overrides={TINY_CLIP!r}'])\n"
            "for m in ('yaml', 'regex', 'ftfy'):\n"
            "    assert sys.modules[m] is None\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert os.path.exists(tmp_path / "run" / "config.yaml")


def test_convert_and_fewshot_dry_run_without_jax(tmp_path):
    """With JAX, the JAX package, Pillow, click, PyYAML and transformers
    blocked, the converter command turns NVlabs state dicts into a
    snapshot, and the training command prints its few-shot Affine+ plan."""
    import numpy as np

    from gagan_tpu_torch.models import stylegan2 as tsg
    from gagan_tpu_torch.utils.checkpoint import tree_to_flat_tensors
    from gagan_tpu_torch.utils.png import write_png

    g = tsg.GeneratorConfig(z_dim=8, w_dim=8, img_resolution=8,
                            mapping=tsg.MappingConfig(num_layers=1),
                            synthesis=tsg.SynthesisConfig(channel_base=32,
                                                          channel_max=8))
    params = tsg.init_generator(g, torch.Generator().manual_seed(0), "cpu")
    sd = tree_to_flat_tensors(params)
    src, dest = str(tmp_path / "nets.pt"), str(tmp_path / "nets.npz")
    torch.save({"G": sd, "G_ema": sd}, src)
    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        write_png(str(data / f"{i}.png"), np.full((32, 32, 3), 40 * i,
                                                  np.uint8))
    flags = ["--use-domain-modulation", "--domain-modulation-parametrization",
             "out_in_additive", "--generator-requires-grad-parts",
             "synt_affine,tRGB_affine,synt_weights_offset.b64,"
             "tRGB_weights_offset.b64", "--glrate", "0.02"]
    code = ("import sys\n"
            "for m in ('jax', 'gagan_tpu', 'PIL', 'click', 'yaml', "
            "'transformers'):\n"
            "    sys.modules[m] = None\n"
            "from gagan_tpu_torch.cli import convert_weights, train\n"
            f"convert_weights.main(['nvlabs', '--src', {src!r}, '--dest', "
            f"{dest!r}])\n"
            f"train.main(['--outdir', {str(tmp_path / 'run')!r}, '--data', "
            f"{str(data)!r}, '--dry-run', '--device', 'cpu'] + {flags!r})\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert "-dm-out_in_additive" in out.stdout and "Dry run" in out.stdout
    with np.load(dest) as f:
        assert {"G/mapping.fc0.weight", "G_ema/synthesis.b8.conv1.weight",
                "__config__"} <= set(f.files)


def test_projection_and_im2im_run_without_pil_yaml_or_jax(tmp_path):
    """With JAX, the JAX package, Pillow, click, PyYAML, regex and ftfy
    blocked: the projector command projects a PNG, and the adapt command
    runs im2im_mtg.yaml (style PNG, projection, MindTheGap steps) on a tiny
    demo generator."""
    import numpy as np

    from gagan_tpu_torch.models import stylegan2 as tsg
    from gagan_tpu_torch.utils import checkpoint as tck
    from gagan_tpu_torch.utils.config import to_dict
    from gagan_tpu_torch.utils.png import write_png

    g = tsg.GeneratorConfig(z_dim=8, w_dim=8, img_resolution=8,
                            mapping=tsg.MappingConfig(num_layers=1),
                            synthesis=tsg.SynthesisConfig(channel_base=32,
                                                          channel_max=8))
    snap = str(tmp_path / "net.npz")
    tck.save_snapshot(snap, g_ema=tsg.init_generator(
        g, torch.Generator().manual_seed(0), "cpu"),
        config={"g_cfg": to_dict(g)})
    style = str(tmp_path / "style.png")
    write_png(style, np.random.RandomState(0).randint(0, 256, (12, 10, 3),
                                                      np.uint8))
    code = ("import sys\n"
            "for m in ('jax', 'gagan_tpu', 'PIL', 'click', 'yaml', 'regex', "
            "'ftfy'):\n"
            "    sys.modules[m] = None\n"
            "from gagan_tpu_torch.cli import adapt, projector\n"
            "from gagan_tpu_torch.entry import TINY_CLIP\n"
            f"projector.main(['--network', {snap!r}, '--target', {style!r}, "
            f"'--outdir', {str(tmp_path / 'proj')!r}, '--space', 'w', "
            "'--num-steps', '2', '--save-image', '--device', 'cpu'])\n"
            "adapt.main(['--config', 'configs/im2im_mtg.yaml', '--network', "
            f"{snap!r}, '--outdir', {str(tmp_path / 'run')!r}, "
            "'--device', 'cpu', 'training.iter_num=1', "
            "'training.batch_size=1', 'inversion.steps=1', "
            f"'training.target_class={style}', "
            "f'training.clip_config_overrides={TINY_CLIP!r}'])\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    env.pop("GAGAN_DETECTOR_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert {"projected_w.npz", "style_proj.png", "style_target.png"} <= set(
        os.listdir(tmp_path / "proj"))
    assert os.path.exists(tmp_path / "run" / "config.yaml")


def test_calc_metrics_and_ga_run_without_pil_yaml_or_jax(tmp_path):
    """With JAX, the JAX package, Pillow, click, PyYAML, regex and ftfy
    blocked: the calc_metrics command computes kid1k (its generated count
    patched to 6, so that the random Inception-v3 stays cheap on the CPU)
    for a tiny snapshot and PNG folder, and the GA search runs in both
    evaluation modes on CPU tensors."""
    import numpy as np

    from gagan_tpu_torch.models import stylegan2 as tsg
    from gagan_tpu_torch.utils import checkpoint as tck
    from gagan_tpu_torch.utils.config import to_dict
    from gagan_tpu_torch.utils.png import write_png

    g = tsg.GeneratorConfig(z_dim=8, w_dim=8, img_resolution=8,
                            mapping=tsg.MappingConfig(num_layers=1),
                            synthesis=tsg.SynthesisConfig(channel_base=32,
                                                          channel_max=8))
    snap = str(tmp_path / "net.npz")
    tck.save_snapshot(snap, g_ema=tsg.init_generator(
        g, torch.Generator().manual_seed(0), "cpu"),
        config={"g_cfg": to_dict(g)})
    data = tmp_path / "data"
    data.mkdir()
    for i in range(6):
        write_png(str(data / f"{i}.png"), np.random.RandomState(i).randint(
            0, 256, (8, 8, 3), np.uint8))
    code = ("import sys\n"
            "for m in ('jax', 'gagan_tpu', 'PIL', 'click', 'yaml', 'regex', "
            "'ftfy'):\n"
            "    sys.modules[m] = None\n"
            "from gagan_tpu_torch import entry\n"
            "from gagan_tpu_torch.cli import calc_metrics\n"
            "from gagan_tpu_torch.ga import search\n"
            "from gagan_tpu_torch.metrics import kid\n"
            "from gagan_tpu_torch.utils.rng import Rng\n"
            "real = kid.compute_kid\n"
            "kid.compute_kid = lambda o, max_real, num_gen: real(o, max_real, "
            "6)\n"
            f"(r,) = calc_metrics.main(['--network', {snap!r}, '--metrics', "
            f"'kid1k', '--data', {str(data)!r}, '--cache-dir', "
            f"{str(tmp_path / 'cache')!r}, '--batch', '3', '--device', "
            "'cpu'])\n"
            "assert r['results']['kid1k'] == r['results']['kid1k']\n"
            "for mode in ('scan', 'batched'):\n"
            "    e = entry.ga_entry('cpu', eval_mode=mode, generations=1)\n"
            "    best, hist = search.evolve_directions(Rng(0), e.g_cfg, "
            "e.g_params, e.fitness_fn, e.cfg)\n"
            "    assert hist.shape == (1,) and best.ndim == 1\n"
            "for m in ('yaml', 'regex', 'ftfy', 'PIL', 'click'):\n"
            "    assert sys.modules[m] is None\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    env.pop("GAGAN_DETECTOR_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert "RANDOM towers" in out.stderr
    assert os.path.exists(tmp_path / "metric-kid1k.jsonl")


def test_inversion_and_editing_run_without_jax_pil_yaml_or_cv2(tmp_path):
    """With JAX, the JAX package, Pillow, click, PyYAML, regex, ftfy and cv2
    blocked: the inversion and editing modules import, the restyle command
    converts a reference-layout checkpoint, project_restyle runs on the npz
    and on a PNG read back, and each editor edits its W+."""
    from gagan_tpu_torch.utils.png import write_png

    from .test_torch_restyle import restyle_checkpoint

    src, dest = str(tmp_path / "restyle.pt"), str(tmp_path / "restyle.npz")
    torch.save(restyle_checkpoint("ResNetBackboneEncoder", 0, 256), src)
    image = str(tmp_path / "face.png")
    write_png(image, np.random.RandomState(0).randint(0, 256, (40, 30, 3),
                                                      np.uint8))
    code = ("import sys\n"
            "for m in ('jax', 'gagan_tpu', 'PIL', 'click', 'yaml', 'regex', "
            "'ftfy', 'cv2'):\n"
            "    sys.modules[m] = None\n"
            "import numpy as np, torch\n"
            "from gagan_tpu_torch import editing, inference\n"
            "from gagan_tpu_torch.cli import convert_weights\n"
            "from gagan_tpu_torch.data.dataset import read_rgb\n"
            "from gagan_tpu_torch.editing import styleflow\n"
            "from gagan_tpu_torch.inversion import e4e_training, ii2s, "
            "restyle\n"
            "from gagan_tpu_torch.utils.rng import Rng\n"
            f"convert_weights.main(['restyle', '--src', {src!r}, '--dest', "
            f"{dest!r}])\n"
            f"img, ws = inference.project_restyle(read_rgb({image!r}), "
            f"{dest!r}, n_iters=1, device='cpu')\n"
            "assert tuple(ws.shape) == (1, 14, 512)\n"
            "ed = editing.LatentEditor({'d': np.ones(512, np.float32)})\n"
            "assert ed.apply_interfacegan(ws, 'd', factor_range=(0, 2))"
            ".shape[0] == 2\n"
            "cfg = styleflow.StyleFlowConfig(hidden_dims=(64,), rk4_steps=4, "
            "solver='rk4')\n"
            "sf = styleflow.StyleFlowEditor(styleflow.init_styleflow(Rng(0), "
            "cfg), cfg, num_ws=14)\n"
            "out = sf.edit(ws, np.zeros(8), np.zeros(9), 0, 1.0)\n"
            "assert torch.isfinite(out).all()\n"
            "for m in ('yaml', 'regex', 'ftfy', 'PIL', 'click', 'cv2'):\n"
            "    assert sys.modules[m] is None\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
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
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.adapt_entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.fewshot_entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.im2im_entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.ga_entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.restyle_entry()


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
