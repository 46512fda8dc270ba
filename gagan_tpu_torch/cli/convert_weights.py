"""Convert PyTorch checkpoints to the npz layout both packages load (port of
tools/convert_weights.py), without JAX.

    python -m gagan_tpu_torch.cli.convert_weights rosinality --src ckpt.pt \\
        --dest out.npz [--size 1024] [--channel-multiplier 2] [--device cuda]
    python -m gagan_tpu_torch.cli.convert_weights nvlabs --src nets.pt --dest out.npz
    python -m gagan_tpu_torch.cli.convert_weights nvlabs --src snap.pkl \\
        --dest out.npz --reference-path DIR
    python -m gagan_tpu_torch.cli.convert_weights openai-clip --src ViT-B-32.pt \\
        --dest vit_b_32.npz
    python -m gagan_tpu_torch.cli.convert_weights hf-clip \\
        --src pytorch_model.bin --dest vit_b_32.npz
    python -m gagan_tpu_torch.cli.convert_weights vgg16 --src vgg16.pth \\
        --dest vgg16.npz [--lpips-lin vgg.pth]
    python -m gagan_tpu_torch.cli.convert_weights inception \\
        --src pt_inception-2015-12-05.pth --dest inception_v3.npz
    python -m gagan_tpu_torch.cli.convert_weights lpips-alex \\
        --src lpips_alex.pth --dest alex.npz [--alexnet-src alexnet.pth]
    python -m gagan_tpu_torch.cli.convert_weights restyle --src restyle.pt \\
        --dest restyle.npz [--size 1024]

* ``rosinality``: a rosinality StyleGAN2 ``.pt`` (its ``g_ema`` entry, or a
  bare state dict) -> a snapshot with ``G_ema/`` only.  The resolution is
  the largest noise buffer's unless ``--size`` is given; ``mapping.w_avg``
  is the mean of the converted mapping network over 4096 latents drawn from
  ``torch.Generator`` seed 0 (the JAX tool draws its own, so the two files
  differ in ``w_avg`` only).
* ``nvlabs``: a ``torch.save``'d dict ``{"G": state_dict, "G_ema": ...,
  "D": ...}`` of NVlabs StyleGAN2-ADA networks -> a snapshot with those
  trees, without the resample filters and the offsets system's masks.
  With ``--reference-path DIR``, ``--src`` is an NVlabs network pickle
  (``network-snapshot-*.pkl``) instead, unpickled with ``DIR`` (a checkout
  whose ``training/`` and ``torch_utils/`` define the pickled classes) on
  ``sys.path``, as the JAX tool reads it; ``sys.path`` and the modules
  imported from ``DIR`` are put back afterwards.  Unpickling runs code
  that the file names: take this route for trusted files only.
* ``openai-clip``: an OpenAI CLIP ``.pt`` (TorchScript archive or state
  dict) -> a CLIP npz (``GAGAN_CLIP_DIR`` of cli/adapt.py).
* ``hf-clip``: a HuggingFace ``CLIPModel`` state dict file
  (``pytorch_model.bin``, read with ``weights_only=True``) -> a CLIP npz.
* ``vgg16``: a torchvision VGG16 state dict, and optionally the LPIPS
  package's VGG ``lin`` weights (``lin{i}.model.1.weight``) -> the npz that
  ``metrics/detectors.py`` reads from ``GAGAN_DETECTOR_DIR`` (``vgg16.npz``).
* ``inception``: pytorch-fid's InceptionV3 state dict -> ``inception_v3.npz``
  for the same directory (``num_batches_tracked`` left out).
* ``lpips-alex``: an ``lpips`` ``LPIPS(net='alex')`` state dict, or the
  package's lin-only ``alex.pth`` with a torchvision AlexNet state dict
  (``--alexnet-src``) -> the npz ``metrics/alexnet.py::load_params`` reads.
* ``restyle``: a ReStyle pSp / e4e checkpoint (``{"state_dict", "opts",
  "latent_avg"}``) -> ``{enc/<key>, dec/<key>, latent_avg, __config__}``,
  which ``inversion/restyle.py::load_net`` (either package's) reads.

``adaptation_from_torch`` (a function, no command) turns a reference
adaptation checkpoint's offset heads into an offsets tree.

Nothing is fetched: every source is a local file.  A snapshot is ``G_ema/``,
``G/``, ``D/`` prefixed dotted keys plus ``__config__`` (JSON as uint8), as
``utils/checkpoint.py`` reads it; a CLIP or VGG16 npz is the tree's dotted
keys.  Every source but an NVlabs pickle is read with
``torch.load(weights_only=True)`` (an OpenAI TorchScript archive with
``torch.jit.load``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..clip.convert import from_hf_state_dict, from_openai_state_dict
from ..models import stylegan2 as sg2
from ..params import offsets as offs_lib
from ..params.sparse import conv_layer_names
from ..utils import checkpoint as ckpt
from ..utils.config import generator_config_from_dict
from ..utils.rng import Rng
from ..utils.torch_import import _DROP_SUFFIXES

W_AVG_SAMPLES = 4096


def _numpy(sd) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in sd.items()}


def save_snapshot(dest: str, g_ema_flat=None, g_flat=None, d_flat=None,
                  config: Optional[Dict] = None):
    """Flat trees under ``G_ema/``, ``G/``, ``D/`` plus ``__config__``
    (``utils/checkpoint.save_snapshot``'s file)."""
    def tree(flat):
        return ckpt.flat_to_tree(flat) if flat else None

    ckpt.save_snapshot(dest, g_params=tree(g_flat), d_params=tree(d_flat),
                       g_ema=tree(g_ema_flat), config=config)


# ----------------------------------------------------------------------------
# rosinality


def rosinality_to_flat(sd: Dict[str, np.ndarray], size: int,
                       style_dim: int = 512, n_mlp: int = 8) -> Dict:
    """rosinality Generator state_dict -> flat NVlabs-style keys (the
    inverse of the reference's karras_to_rosinality correspondence);
    ``mapping.w_avg`` is zeros until :func:`mapping_w_avg` fills it."""
    out = {}
    for i in range(n_mlp):
        # style.0 is the PixelNorm; the EqualLinear layers start at style.1.
        out[f"mapping.fc{i}.weight"] = sd[f"style.{i + 1}.weight"]
        out[f"mapping.fc{i}.bias"] = sd[f"style.{i + 1}.bias"]
    out["mapping.w_avg"] = np.zeros(style_dim, np.float32)
    out["synthesis.b4.const"] = sd["input.input"][0]

    def conv_entry(prefix, dst, noise_key):
        out[f"{dst}.weight"] = sd[f"{prefix}.conv.weight"][0]
        out[f"{dst}.affine.weight"] = sd[f"{prefix}.conv.modulation.weight"]
        out[f"{dst}.affine.bias"] = sd[f"{prefix}.conv.modulation.bias"]
        out[f"{dst}.noise_strength"] = sd[f"{prefix}.noise.weight"].reshape(())
        out[f"{dst}.bias"] = sd[f"{prefix}.activate.bias"]
        out[f"{dst}.noise_const"] = sd[noise_key][0, 0]

    def torgb_entry(prefix, dst):
        out[f"{dst}.weight"] = sd[f"{prefix}.conv.weight"][0]
        out[f"{dst}.affine.weight"] = sd[f"{prefix}.conv.modulation.weight"]
        out[f"{dst}.affine.bias"] = sd[f"{prefix}.conv.modulation.bias"]
        out[f"{dst}.bias"] = sd[f"{prefix}.bias"].reshape(-1)

    conv_entry("conv1", "synthesis.b4.conv1", "noises.noise_0")
    torgb_entry("to_rgb1", "synthesis.b4.torgb")
    layer_idx = 1
    for block_i, i in enumerate(range(3, int(math.log2(size)) + 1)):
        res = 2 ** i
        conv_entry(f"convs.{2 * block_i}", f"synthesis.b{res}.conv0",
                   f"noises.noise_{layer_idx}")
        conv_entry(f"convs.{2 * block_i + 1}", f"synthesis.b{res}.conv1",
                   f"noises.noise_{layer_idx + 1}")
        torgb_entry(f"to_rgbs.{block_i}", f"synthesis.b{res}.torgb")
        layer_idx += 2
    return out


def rosinality_config(size: int, channel_multiplier: int = 2,
                      n_mlp: int = 8) -> Dict:
    """The snapshot config of a rosinality generator: rosinality's
    ``channel_multiplier=cm`` is NVlabs' ``channel_base=16384*cm``."""
    return {"g_cfg": {
        "z_dim": 512, "c_dim": 0, "w_dim": 512, "img_resolution": size,
        "img_channels": 3,
        "mapping": {"num_layers": n_mlp, "lr_multiplier": 0.01},
        "synthesis": {"channel_base": 16384 * channel_multiplier,
                      "channel_max": 512}}}


def mapping_w_avg(flat: Dict, config: Dict, z: torch.Tensor) -> np.ndarray:
    """The mean of the mapping network's w over the latents ``z``."""
    g_cfg = generator_config_from_dict(config["g_cfg"])
    mapping = ckpt.flat_to_tree(
        {k[len("mapping."):]: v for k, v in flat.items()
         if k.startswith("mapping.")}, device=z.device)
    with torch.no_grad():
        ws = sg2.mapping_apply(g_cfg.mapping, mapping, z, broadcast=False)
    return ws.mean(dim=0).cpu().numpy()


def _load(src: str):
    """``torch.load`` of tensors, containers and argparse namespaces only
    (a rosinality checkpoint keeps its training args as one)."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(src, map_location="cpu", weights_only=True)


def convert_rosinality(src: str, dest: str, size: Optional[int] = None,
                       channel_multiplier: int = 2, n_mlp: int = 8,
                       device="cuda", z: Optional[torch.Tensor] = None):
    """``z``: the latents of the ``w_avg`` mean (default: 4096 draws of
    ``torch.Generator`` seed 0) on ``device``."""
    device = resolve_device(device)
    ckpt_obj = _load(src)
    sd = _numpy(ckpt_obj.get("g_ema", ckpt_obj))
    if size is None:
        size = max(v.shape[-1] for k, v in sd.items() if k.startswith("noises."))
    flat = rosinality_to_flat(sd, size, n_mlp=n_mlp)
    config = rosinality_config(size, channel_multiplier, n_mlp)
    if z is None:
        z = torch.randn((W_AVG_SAMPLES, 512),
                        generator=torch.Generator().manual_seed(0))
    flat["mapping.w_avg"] = mapping_w_avg(flat, config, z.to(device))
    save_snapshot(dest, g_ema_flat=flat, config=config)
    print(f"converted rosinality ckpt ({size}px) -> {dest}")


# ----------------------------------------------------------------------------
# NVlabs


def _keep(key: str) -> bool:
    return not any(key.endswith(s) for s in _DROP_SUFFIXES)


def nvlabs_generator_config(sd: Dict[str, np.ndarray]) -> Dict:
    """The keys the JAX tool reads off an NVlabs ``Generator`` module
    (``z_dim``, ``c_dim``, ``w_dim``, ``img_resolution``, ``img_channels``),
    here from the shapes of its state dict."""
    c_dim = sd["mapping.embed.weight"].shape[1] if "mapping.embed.weight" in sd else 0
    embed = sd["mapping.embed.weight"].shape[0] if c_dim else 0
    res = max(int(k.split(".")[1][1:]) for k in sd
              if k.startswith("synthesis.b") and k.split(".")[1][1:].isdigit())
    return {"z_dim": sd["mapping.fc0.weight"].shape[1] - embed,
            "c_dim": c_dim, "w_dim": sd["mapping.w_avg"].shape[0],
            "img_resolution": res,
            "img_channels": sd[f"synthesis.b{res}.torgb.weight"].shape[0]}


def convert_nvlabs(src: str, dest: str):
    try:
        nets = _load(src)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{src} is not a torch.save'd dict of state dicts: an NVlabs "
            f"network pickle needs --reference-path DIR, a checkout that "
            f"defines its classes") from e
    out, config = {}, {}
    for name in ("G_ema", "G", "D"):
        sd = nets.get(name)
        if sd is None:
            continue
        out[name] = {k: v for k, v in _numpy(sd).items() if _keep(k)}
        if name == "G_ema":
            config["g_cfg"] = nvlabs_generator_config(out[name])
    save_snapshot(dest, g_ema_flat=out.get("G_ema"), g_flat=out.get("G"),
                  d_flat=out.get("D"), config=config)
    print(f"converted NVlabs state dicts ({', '.join(out)}) -> {dest}")


def _imported_from(modules, root: str):
    """The names of ``modules`` whose file (or, for a namespace package,
    first directory) lies under ``root``."""
    root = os.path.join(os.path.realpath(root), "")

    def where(mod):
        return (getattr(mod, "__file__", None)
                or next(iter(getattr(mod, "__path__", None) or []), ""))
    return [name for name, mod in modules.items()
            if os.path.realpath(where(mod)).startswith(root)]


def load_nvlabs_pickle(src: str, reference_path: str) -> Dict:
    """{name: (state dict as numpy without the dropped buffers, module)} of
    the ``G_ema``, ``G`` and ``D`` networks of an NVlabs network pickle,
    unpickled with ``reference_path`` first on ``sys.path`` (the JAX tool's
    ``convert_nvlabs_pkl``).  Unpickling runs code the file names: trusted
    files only.  ``sys.path`` is put back and the modules imported from
    ``reference_path`` are dropped from ``sys.modules`` afterwards, so that
    its ``training`` and ``torch_utils`` do not shadow later imports."""
    path = list(sys.path)
    before = set(sys.modules)
    sys.path.insert(0, reference_path)
    try:
        with open(src, "rb") as f:
            data = pickle.load(f)
    finally:
        sys.path[:] = path
        for name in _imported_from({k: v for k, v in sys.modules.items()
                                    if k not in before}, reference_path):
            del sys.modules[name]
    return {name: ({k: v for k, v in _numpy(data[name].state_dict()).items()
                    if _keep(k)}, data[name])
            for name in ("G_ema", "G", "D") if data.get(name) is not None}


def convert_nvlabs_pkl(src: str, dest: str, reference_path: str):
    """An NVlabs network pickle -> a snapshot: :func:`load_nvlabs_pickle`'s
    trees, and ``g_cfg`` from the ``G_ema`` module's attributes, as the JAX
    tool writes them."""
    nets = load_nvlabs_pickle(src, reference_path)
    config = {}
    if "G_ema" in nets:
        g = nets["G_ema"][1]
        config["g_cfg"] = {"z_dim": g.z_dim, "c_dim": g.c_dim,
                           "w_dim": g.w_dim,
                           "img_resolution": g.img_resolution,
                           "img_channels": g.img_channels}
    flat = {name: sd for name, (sd, _) in nets.items()}
    save_snapshot(dest, g_ema_flat=flat.get("G_ema"), g_flat=flat.get("G"),
                  d_flat=flat.get("D"), config=config)
    print(f"converted NVlabs pkl ({', '.join(nets)}) -> {dest}")


# ----------------------------------------------------------------------------
# CLIP


def convert_openai_clip(src: str, dest: str):
    """src: an OpenAI CLIP .pt (TorchScript archive or state dict)."""
    try:
        sd = torch.jit.load(src, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(src, map_location="cpu", weights_only=True)
    np.savez(dest, **ckpt.tree_to_flat(from_openai_state_dict(sd)))
    print(f"converted OpenAI CLIP -> {dest}")


def convert_hf_clip(src: str, dest: str):
    """src: a transformers CLIPModel state dict file (pytorch_model.bin)."""
    sd = torch.load(src, map_location="cpu", weights_only=True)
    np.savez(dest, **ckpt.tree_to_flat(from_hf_state_dict(sd)))
    print(f"converted HF CLIP -> {dest}")


# ----------------------------------------------------------------------------
# VGG16 (LPIPS)


def convert_vgg16(src: str, dest: str, lpips_lin: Optional[str] = None):
    """src: a torchvision vgg16 state dict; lpips_lin: the LPIPS package's
    VGG lin weights (.pth)."""
    flat = _numpy(torch.load(src, map_location="cpu", weights_only=True))
    if lpips_lin:
        lin = torch.load(lpips_lin, map_location="cpu", weights_only=True)
        for i in range(5):
            flat[f"lin.{i}.weight"] = lin[f"lin{i}.model.1.weight"].numpy(
            ).reshape(-1)
    np.savez(dest, **flat)
    print(f"converted VGG16 -> {dest}")


# ----------------------------------------------------------------------------
# InceptionV3 (FID) and AlexNet (LPIPS)


def convert_inception(src: str, dest: str):
    """src: pytorch-fid's pt_inception-2015-12-05 state dict (.pth)."""
    sd = torch.load(src, map_location="cpu", weights_only=True)
    np.savez(dest, **{k: v.numpy() for k, v in sd.items()
                      if "num_batches_tracked" not in k})
    print(f"converted InceptionV3 -> {dest}")


def lpips_alex_to_flat(sd: Dict, alexnet_sd: Optional[Dict] = None) -> Dict:
    """lpips-package LPIPS(net='alex') weights -> metrics/alexnet.py's flat
    keys: a full LPIPS state dict (``net.sliceK.I.*``, ``linI.model.1.weight``,
    ``scaling_layer.*``), or the lin-only weight file plus a torchvision
    AlexNet state dict for the tower."""
    sd, alexnet_sd = _numpy(sd), _numpy(alexnet_sd or {})
    flat = {}
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in sd:
                flat[f"lin.{i}.weight"] = sd[key].reshape(-1)
                break
        else:
            raise KeyError(f"lin{i} weight not found")
    for k, v in sd.items():
        if k.startswith("net.slice"):       # net.sliceK.<tv_idx>.<param>
            _, _, idx, param = k.split(".")
            flat[f"features.{idx}.{param}"] = v
    for k, v in alexnet_sd.items():
        if k.startswith("features."):
            flat[k] = v
    if "scaling_layer.shift" in sd:
        flat["scaling.shift"] = sd["scaling_layer.shift"].reshape(-1)
        flat["scaling.scale"] = sd["scaling_layer.scale"].reshape(-1)
    missing = [i for i in (0, 3, 6, 8, 10)
               if f"features.{i}.weight" not in flat]
    if missing:
        raise KeyError(f"AlexNet conv weights missing for features "
                       f"{missing}: pass a torchvision alexnet state_dict")
    return flat


def convert_lpips_alex(src: str, dest: str, alexnet_src: Optional[str] = None):
    sd = torch.load(src, map_location="cpu", weights_only=True)
    alex_sd = (torch.load(alexnet_src, map_location="cpu", weights_only=True)
               if alexnet_src else None)
    np.savez(dest, **lpips_alex_to_flat(sd, alex_sd))
    print(f"converted LPIPS-alex -> {dest}")


# ----------------------------------------------------------------------------
# ReStyle pSp / e4e checkpoints


def restyle_from_torch(ckpt_obj: Dict, size: Optional[int] = None):
    """A ReStyle checkpoint ({state_dict, opts, latent_avg}) -> (enc_flat,
    dec_flat, latent_avg, meta): the ``encoder.*`` keys as they are (without
    ``num_batches_tracked``), the ``decoder.*`` rosinality generator through
    :func:`rosinality_to_flat` (8 mapping layers), a [512] latent_avg tiled
    over the W+ layers."""
    sd = ckpt_obj["state_dict"]
    opts = ckpt_obj.get("opts", {}) or {}
    if isinstance(opts, argparse.Namespace):
        opts = dict(vars(opts))
    size = size or int(opts.get("output_size", 1024))
    enc_flat = {k[len("encoder."):]: v for k, v in _numpy(sd).items()
                if k.startswith("encoder.") and "num_batches_tracked" not in k}
    dec_sd = {k[len("decoder."):]: v for k, v in _numpy(sd).items()
              if k.startswith("decoder.")}
    dec_flat = rosinality_to_flat(dec_sd, size=size, n_mlp=8) if dec_sd else {}
    latent_avg = ckpt_obj.get("latent_avg")
    if latent_avg is not None:
        latent_avg = _numpy({"a": latent_avg})["a"]
        if latent_avg.ndim == 1:
            latent_avg = np.tile(latent_avg[None],
                                 (2 * int(np.log2(size)) - 2, 1))
    meta = {"encoder_type": opts.get("encoder_type",
                                     "ProgressiveBackboneEncoder"),
            "output_size": size,
            "input_nc": int(opts.get("input_nc", 6))}
    return enc_flat, dec_flat, latent_avg, meta


def convert_restyle(src: str, dest: str, size: Optional[int] = None):
    enc_flat, dec_flat, latent_avg, meta = restyle_from_torch(_load(src), size)
    arrays = {f"enc/{k}": v for k, v in enc_flat.items()}
    arrays.update({f"dec/{k}": v for k, v in dec_flat.items()})
    if latent_avg is not None:
        arrays["latent_avg"] = latent_avg
    arrays["__config__"] = np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8)
    np.savez(dest, **arrays)
    print(f"converted ReStyle {meta['encoder_type']} -> {dest}")


# ----------------------------------------------------------------------------
# Adaptation checkpoints of the reference

# Offset-head parameter -> offsets leaf, by patch_key.
_ADAPT_HEAD_LEAF = {
    "s_delta": {"params_in": "offset"},
    "s_mod": {"params_in": "offset"},
    "w_delta": {"w_offsets": "offset"},
    "w_mod": {"w_offsets": "offset"},
    "cin_mult": {"params_in": "weights_offset"},
    "cin_delta": {"params_in": "weights_offset"},
    "cin_offset": {"params_in": "weights_offset"},
    "cout_mult": {"params_out": "weights_offset"},
    "cfull_mult": {"shift": "weights_offset"},
    "cfull_delta": {"shift": "weights_offset"},
}


def adaptation_from_torch(obj: Dict, syn_cfg: Optional[sg2.SynthesisConfig]
                          = None):
    """A reference adaptation checkpoint ({model_type, patch_key,
    state_dict, sg2_params}) -> (meta, offsets tree of numpy arrays).  The
    reference trains one head per conv, ``heads.conv_{i}`` over the
    rosinality conv list (ToRGBs excluded), which maps onto
    ``conv_layer_names`` in order; the other leaves stay at the zeros of
    ``init_offsets``.  ``meta`` counts the heads consumed and expected."""
    patch_key = obj.get("patch_key") or obj.get("parametrization")
    if patch_key not in _ADAPT_HEAD_LEAF:
        raise ValueError(f"unsupported patch_key for conversion: {patch_key}")
    leaf_map = _ADAPT_HEAD_LEAF[patch_key]
    sd = _numpy(obj["state_dict"])
    if syn_cfg is None:
        size = int(obj.get("sg2_params", {}).get("img_size", 1024))
        syn_cfg = sg2.GeneratorConfig(img_resolution=size).synthesis
    names = conv_layer_names(syn_cfg)
    spec = offs_lib.OffsetsSpec.from_string(patch_key)
    offsets = {name: {k: np.zeros(tuple(v.shape), np.float32)
                      for k, v in layer.items()}
               for name, layer in offs_lib.init_offsets(
                   Rng(0), syn_cfg, spec).items()}
    consumed = 0
    for key, arr in sd.items():
        parts = key.split(".")          # heads.conv_{i}.{param}
        if len(parts) != 3 or parts[0] != "heads":
            continue
        idx = int(parts[1].split("_")[1])
        leaf = leaf_map.get(parts[2])
        if leaf is None or idx >= len(names):
            continue
        dst = offsets[names[idx]][leaf]
        offsets[names[idx]][leaf] = arr.reshape(dst.shape).astype(dst.dtype)
        consumed += 1
    meta = {"model_type": obj.get("model_type", "parametrization"),
            "parametrization": patch_key,
            "sg2_params": dict(obj.get("sg2_params", {})),
            "heads_consumed": consumed,
            "heads_expected": sum(1 for k in sd if k.startswith("heads.")
                                  and k.split(".")[-1] in leaf_map)}
    return meta, offsets


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Convert PyTorch checkpoints to gagan npz files.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("rosinality", "nvlabs", "openai-clip", "hf-clip", "vgg16",
                 "inception", "lpips-alex", "restyle"):
        sp = sub.add_parser(name)
        sp.add_argument("--src", required=True)
        sp.add_argument("--dest", required=True)
        if name == "rosinality":
            sp.add_argument("--size", type=int, default=None)
            sp.add_argument("--channel-multiplier", type=int, default=2)
            sp.add_argument("--n-mlp", type=int, default=8)
            sp.add_argument("--device", default="cuda",
                            help="torch device of the w_avg mean (default "
                                 "cuda)")
        if name == "nvlabs":
            sp.add_argument(
                "--reference-path", default=None, metavar="DIR",
                help="--src is an NVlabs network pickle: unpickle it with "
                     "DIR (a checkout defining training/ and torch_utils/) "
                     "on sys.path.  Unpickling runs code that the file "
                     "names: trusted files only")
        if name == "restyle":
            sp.add_argument("--size", type=int, default=None,
                            help="the decoder's resolution (default: the "
                                 "checkpoint's opts.output_size, else 1024)")
        if name == "vgg16":
            sp.add_argument("--lpips-lin", default=None,
                            help="the LPIPS package's VGG lin weights")
        if name == "lpips-alex":
            sp.add_argument("--alexnet-src", default=None,
                            help="torchvision alexnet state dict (when src "
                                 "is the lin-only lpips alex.pth)")
    return ap


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    if args.cmd == "rosinality":
        convert_rosinality(args.src, args.dest, size=args.size,
                           channel_multiplier=args.channel_multiplier,
                           n_mlp=args.n_mlp, device=args.device)
    elif args.cmd == "nvlabs" and args.reference_path:
        convert_nvlabs_pkl(args.src, args.dest, args.reference_path)
    elif args.cmd == "nvlabs":
        convert_nvlabs(args.src, args.dest)
    elif args.cmd == "openai-clip":
        convert_openai_clip(args.src, args.dest)
    elif args.cmd == "vgg16":
        convert_vgg16(args.src, args.dest, args.lpips_lin)
    elif args.cmd == "inception":
        convert_inception(args.src, args.dest)
    elif args.cmd == "lpips-alex":
        convert_lpips_alex(args.src, args.dest, args.alexnet_src)
    elif args.cmd == "restyle":
        convert_restyle(args.src, args.dest, size=args.size)
    else:
        convert_hf_clip(args.src, args.dest)


if __name__ == "__main__":
    main()
