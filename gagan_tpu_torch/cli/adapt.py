"""One-shot domain adaptation from a YAML experiment config (port of
gagan_tpu/cli/adapt.py): StyleGAN-NADA (``td_single``) from text, and
MindTheGap (``im2im_single``), JoJoGAN (``im2im_JoJo``) and DiFa
(``im2im_difa``) from a style image.

    python -m gagan_tpu_torch.cli.adapt --config configs/td_nada_sdelta.yaml \\
        --network snap.npz training.target_class="Anime" exp.name=run1 \\
        [--device cuda]
    python -m gagan_tpu_torch.cli.adapt --config configs/im2im_difa.yaml \\
        --network snap.npz training.target_class=style.png

Trailing ``KEY=VALUE`` arguments override the YAML (``utils/config.
apply_dotlist``).  The source generator comes from ``--network`` or
``exp.checkpoint``; without either a freshly initialized generator is used
(demo mode).  CLIP weights load from ``GAGAN_CLIP_DIR`` (``vit_b_32.npz`` /
``vit_b_16.npz``, the JAX package's flat keys); without them a random tower
of the real shape is used (``training.clip_config_overrides`` shrinks it,
for small runs), and without a BPE vocab (``GAGAN_CLIP_BPE``) the byte-level
tokenizer: the machinery runs, the semantics need the real files.

The im2im trainers read the style image ``training.target_class`` (PNG
without Pillow; other formats need it), resized to the generator's
resolution as Pillow's default bicubic does, and its W+ latents from
``inversion.latents`` (an npz with ``w``), else project it
(inversion/projector.py, ``inversion.steps`` steps, VGG16-LPIPS from
``GAGAN_DETECTOR_DIR`` or random).  ``difa_w`` is DiFa's SCC loss: its e4e
encoder loads from ``inversion.e4e_checkpoint`` (a configured path that is
missing is an error), else random weights of the real shape, announced.

Writes ``config.yaml`` (the resolved config), ``losses.jsonl`` (every
``logging.log_every`` steps) and ``adaptation-NNNNNN.npz`` checkpoints
(every ``checkpointing.step_backup`` steps), which ``cli/generate.py
--s-direction`` and ``inference.Inferencer`` read.  YAML is read and
written by ``utils/yaml_subset.py``.  Runs on CUDA unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..clip import model as clip_model
from ..clip.tokenizer import SimpleTokenizer, tokenize
from ..data.dataset import read_rgb
from ..inversion import encoders as enc_lib
from ..inversion import projector
from ..models import stylegan2 as sg2
from ..ops.resize import resize_uint8
from ..train import adapt_losses as al
from ..train import adaptation as ad
from ..utils import checkpoint as ckpt
from ..utils import config as config_lib
from ..utils import yaml_subset
from ..utils.rng import Rng
from ..utils.text_templates import imagenet_templates
from .generate import load_generator

CLIP_CONFIGS = {"ViT-B/32": (clip_model.VIT_B_32, "vit_b_32.npz"),
                "ViT-B/16": (clip_model.VIT_B_16, "vit_b_16.npz")}


def load_clip_encoders(names, device, overrides: Optional[Dict] = None):
    """{name: (CLIPConfig, params on ``device``)}: converted weights from
    ``GAGAN_CLIP_DIR``, else a random tower (seed 0) with ``overrides``
    replacing CLIPConfig fields."""
    out = {}
    clip_dir = os.environ.get("GAGAN_CLIP_DIR", "")
    for name in names:
        ccfg, fname = CLIP_CONFIGS[name]
        path = os.path.join(clip_dir, fname) if clip_dir else ""
        if path and os.path.isfile(path):
            with np.load(path, allow_pickle=False) as data:
                params = ckpt.flat_to_tree({k: data[k] for k in data.files},
                                           device)
        else:
            print(f"[adapt] no converted weights for {name}; using random "
                  f"CLIP (set GAGAN_CLIP_DIR)")
            if overrides:
                ccfg = dataclasses.replace(ccfg, **overrides)
            params = clip_model.init_clip(torch.Generator().manual_seed(0),
                                          ccfg, device)
        out[name] = (ccfg, params)
    return out


def text_embeddings(encoders, source_class: str, target_class: str,
                    templates) -> Dict[str, Dict[str, torch.Tensor]]:
    """encode_text over the templates: {name: {"src": [1, T, D], "trg":
    [1, T, D]}}; the direction loss averages the template axis."""
    tok = SimpleTokenizer()
    emb = {}
    for name, (ccfg, cparams) in encoders.items():
        device = cparams["text_projection"].device
        out = {}
        for key, text in (("src", source_class), ("trg", target_class)):
            tokens = tokenize([t.format(text) for t in templates], tok,
                              ccfg.context_length)
            with torch.no_grad():
                out[key] = clip_model.encode_text(
                    ccfg, cparams, torch.from_numpy(tokens).to(device))[None]
        emb[name] = out
    return emb


def demo_generator_config(training: Dict) -> sg2.GeneratorConfig:
    """The generator of demo mode (no --network), from training.* keys."""
    gen_args = training.get("generator_args", {})
    return sg2.GeneratorConfig(
        img_resolution=int(training.get("img_resolution", 256)),
        z_dim=int(gen_args.get("z_dim", 512)),
        w_dim=int(gen_args.get("w_dim", 512)),
        mapping=sg2.MappingConfig(
            num_layers=int(gen_args.get("num_mapping_layers", 8))),
        synthesis=sg2.SynthesisConfig(
            channel_base=int(gen_args.get("channel_base", 32768)),
            channel_max=int(gen_args.get("channel_max", 512))))


def adaptation_config(cfg_dict: Dict) -> ad.AdaptationConfig:
    """The config blocks -> AdaptationConfig, as the JAX command maps them
    (difa_w becomes the SCC loss)."""
    exp = cfg_dict.get("exp", {})
    training = cfg_dict.get("training", {})
    opt = cfg_dict.get("optimization_setup", {})
    loss_funcs = tuple(opt.get("loss_funcs", ["direction"]))
    loss_coefs = tuple(opt.get("loss_coefs", [1.0]))
    scc = None
    if "difa_w" in loss_funcs:
        idx = loss_funcs.index("difa_w")
        scc = al.SCCConfig(weight=loss_coefs[idx])
        loss_funcs = loss_funcs[:idx] + loss_funcs[idx + 1:]
        loss_coefs = loss_coefs[:idx] + loss_coefs[idx + 1:]
    return ad.AdaptationConfig(
        trainer=exp.get("trainer", "td_single"),
        batch_size=int(training.get("batch_size", 4)),
        iter_num=int(training.get("iter_num", 301)),
        lr=float(opt.get("lr", 0.002)),
        mixing_noise=float(training.get("mixing_noise", 0.9)),
        source_class=training.get("source_class", "Photo"),
        target_class=training.get("target_class", ""),
        parametrization=training.get("patch_key", "additive"),
        visual_encoders=tuple(training.get("visual_encoders", ["ViT-B/32"])),
        clip_layer=int(training.get("clip_layer", 8)),
        alpha=float(training.get("alpha", 0.0)),
        preserve_color=bool(training.get("preserve_color", False)),
        loss=al.DirectLossConfig(loss_funcs=loss_funcs,
                                 loss_coefs=loss_coefs, scc=scc),
        log_every=int(cfg_dict.get("logging", {}).get("log_every", 10)),
        checkpoint_every=int(cfg_dict.get("checkpointing", {}).get(
            "step_backup", 100)))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="One-shot domain adaptation from a YAML config "
                    "(PyTorch port); trailing KEY=VALUE arguments override "
                    "the YAML.")
    ap.add_argument("--config", dest="config_path", required=True,
                    help="YAML experiment config (configs/*.yaml: td_nada, "
                         "im2im_mtg, im2im_jojo, im2im_difa and their "
                         "variants)")
    ap.add_argument("--network", default=None,
                    help="Source generator snapshot npz; overrides "
                         "exp.checkpoint.  Without either, a freshly "
                         "initialized generator is used (demo mode).")
    ap.add_argument("--outdir", default=None,
                    help="Output directory; default <exp.root>/<exp.name>")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    return ap


def latent_encoder(cfg_dict: Dict, g_cfg: sg2.GeneratorConfig, device):
    """(EncoderConfig, params) of e4e for difa_w: the converted npz of
    ``inversion.e4e_checkpoint``, else random weights (seed 7)."""
    e_cfg = enc_lib.EncoderConfig(stylegan_size=g_cfg.img_resolution)
    path = cfg_dict.get("inversion", {}).get("e4e_checkpoint", "")
    if path:
        with np.load(path, allow_pickle=False) as data:
            return e_cfg, ckpt.flat_to_tree({k: data[k] for k in data.files},
                                            device)
    print("[adapt] difa_w: no inversion.e4e_checkpoint; using a random e4e "
          "encoder (machinery runs; semantics need real weights)")
    return e_cfg, enc_lib.init_encoder(torch.Generator().manual_seed(7),
                                       e_cfg, device)


def style_inputs(cfg_dict: Dict, acfg: ad.AdaptationConfig,
                 g_cfg: sg2.GeneratorConfig, g_params, device) -> Dict:
    """The style image (uint8 [3, R, R]) and its W+ latents [1, num_ws,
    w_dim]: from ``inversion.latents``, else projected."""
    res = g_cfg.img_resolution
    img = resize_uint8(read_rgb(acfg.target_class), (res, res),
                       "bicubic").transpose(2, 0, 1)
    inversion = cfg_dict.get("inversion", {})
    if inversion.get("latents"):
        with np.load(inversion["latents"]) as data:
            w = data["w"]
    else:
        print("[adapt] projecting style image (no cached latents)",
              flush=True)
        w = projector.project(g_cfg, g_params, img,
                              num_steps=int(inversion.get("steps", 300)),
                              rng=Rng(0))
    return {"style_image": img, "style_latents": w[None] if w.ndim == 2 else w}


def main(argv: Optional[List[str]] = None) -> ad.AdaptationTrainer:
    """Run the experiment; returns the trainer after its last step."""
    ap = build_parser()
    args, overrides = ap.parse_known_args(argv)
    bad = [a for a in overrides if "=" not in a or a.startswith("-")]
    if bad:
        ap.error(f"unrecognized arguments: {' '.join(bad)}")
    device = resolve_device(args.device)
    cfg_dict = config_lib.apply_dotlist(yaml_subset.read(args.config_path),
                                        overrides)
    acfg = adaptation_config(cfg_dict)
    exp = cfg_dict.get("exp", {})
    training = cfg_dict.get("training", {})
    ad.AdaptationTrainer.check_config(acfg)      # before loading anything
    e4e_path = cfg_dict.get("inversion", {}).get("e4e_checkpoint", "")
    if acfg.loss.scc is not None and e4e_path and not os.path.isfile(e4e_path):
        # A typo'd path must not train with a random encoder unnoticed.
        raise FileNotFoundError(
            f"inversion.e4e_checkpoint={e4e_path!r} does not exist (difa_w "
            f"needs the converted e4e npz; drop the key to run with "
            f"announced random weights)")

    network = args.network or exp.get("checkpoint")
    outdir = args.outdir or (exp.get("root", "runs/adapt") + "/"
                             + exp.get("name", "exp"))
    os.makedirs(outdir, exist_ok=True)
    if network:
        g_cfg, g_params = load_generator(network, device)
    else:
        print("[adapt] no --network; using a freshly initialized generator "
              "(demo mode)")
        g_cfg = demo_generator_config(training)
        g_params = sg2.init_generator(g_cfg, torch.Generator().manual_seed(0),
                                      device)
    encoders = load_clip_encoders(acfg.visual_encoders, device,
                                  training.get("clip_config_overrides"))
    kwargs: Dict = {}
    if acfg.loss.scc is not None:
        kwargs["latent_encoder"] = latent_encoder(cfg_dict, g_cfg, device)
    if acfg.trainer == "td_single":
        kwargs["domain_embeddings"] = text_embeddings(
            encoders, acfg.source_class, acfg.target_class,
            imagenet_templates)
    else:
        kwargs.update(style_inputs(cfg_dict, acfg, g_cfg, g_params, device))
    trainer = ad.AdaptationTrainer(acfg, g_cfg, g_params, encoders,
                                   Rng(int(exp.get("seed", 0))),
                                   device=device, **kwargs)

    yaml_subset.write(os.path.join(outdir, "config.yaml"), cfg_dict)
    log_path = os.path.join(outdir, "losses.jsonl")

    def log_fn(step, losses):
        with open(log_path, "a") as f:
            f.write(json.dumps({"step": step, **losses}) + "\n")
        print(f"step {step}: total {losses['total']:.4f}", flush=True)

    trainer.train(log_fn=log_fn, checkpoint_dir=outdir)
    print(f"done; checkpoints in {outdir}")
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
