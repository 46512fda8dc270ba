"""The plain reference of the one-shot adaptation cells: the frozen copy of
the ``td_single`` trainer, with G and the CLIP tower in float32 (TF32 off),
on the weights, embeddings and draw source that the benchmark hands to
both sides."""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from . import generate_ref
from .frozen.ops import conv2d_gradfix
from .frozen.clip import model as clip_model
from .frozen.params import offsets as offs_lib
from .frozen.train import adapt_losses as al
from .frozen.train import adaptation as ad
from .frozen.utils.checkpoint import tree_to_flat_tensors
from .frozen.utils.rng import Rng


def clip_config(c: Dict[str, Any]) -> clip_model.CLIPConfig:
    v = c["clip_vit_b32"]
    return clip_model.CLIPConfig(
        embed_dim=v["embed_dim"], image_resolution=v["image_resolution"],
        vision_layers=v["vision_layers"], vision_width=v["vision_width"],
        vision_patch_size=v["vision_patch_size"],
        vision_heads_override=v["vision_heads"])


def trainer_config(t: Dict[str, Any], clip_dtype: str) -> ad.AdaptationConfig:
    """``cli/adapt.py::adaptation_config`` of the mix's YAML blocks, for
    the td_single trainer."""
    d = t["adapt_config"]
    exp, training = d["exp"], d["training"]
    opt = d["optimization_setup"]
    return ad.AdaptationConfig(
        trainer=exp["trainer"], batch_size=int(training["batch_size"]),
        lr=float(opt["lr"]), mixing_noise=float(training["mixing_noise"]),
        parametrization=training["patch_key"],
        visual_encoders=tuple(training["visual_encoders"]),
        clip_dtype=clip_dtype,
        loss=al.DirectLossConfig(loss_funcs=tuple(opt["loss_funcs"]),
                                 loss_coefs=tuple(opt["loss_coefs"])))


def make_inputs(c: Dict[str, Any], t: Dict[str, Any], seed: int, device):
    """G's weights (``generate_ref.make_weights``), the CLIP tower drawn on
    ``device`` from seed + 1, the source and target text embeddings: unit
    vectors [1, templates, embed_dim] from seed + 2, and the offsets the
    trainer starts from: N(0, ``initial_offsets_std``^2) from seed + 3, as
    a job resumed part way does (at zero offsets the trainable and frozen
    images are alike and the direction loss's first gradient is that of a
    difference of two nearly equal embeddings)."""
    g_params = generate_ref.make_weights(c, seed, device)
    ccfg = clip_config(c)
    cparams = clip_model.init_clip(
        torch.Generator(device=device).manual_seed(seed + 1), ccfg, device)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    emb = {}
    for name in t["adapt_config"]["training"]["visual_encoders"]:
        e = torch.randn((2, t["templates"], ccfg.embed_dim), generator=gen,
                        device=device)
        e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
        emb[name] = {"src": e[:1], "trg": e[1:]}
    spec = offs_lib.OffsetsSpec.from_string(
        t["adapt_config"]["training"]["patch_key"])
    offsets = offs_lib.init_offsets(Rng(seed), generate_ref.g_config(c)
                                    .synthesis, spec, device)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    with torch.no_grad():
        for leaf in tree_to_flat_tensors(offsets).values():
            leaf.add_(torch.randn(leaf.shape, generator=gen, device=device)
                      * t["initial_offsets_std"])
    return g_params, ccfg, cparams, emb, offsets


def opt_norms(opt) -> Dict[str, float]:
    """Per offsets leaf, the norms of Adam's two moments."""
    out = {}
    for k, v in opt.mu.items():
        out["mu/" + k] = float(torch.linalg.vector_norm(v.float()))
    for k, v in opt.nu.items():
        out["rootnu/" + k] = float(torch.linalg.vector_norm(v.float().sqrt()))
    return out


def offsets_snapshot(offsets) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in
            tree_to_flat_tensors(offsets).items()}


def change_norms(before, offsets) -> Dict[str, float]:
    after = tree_to_flat_tensors(offsets)
    return {k: float(torch.linalg.vector_norm(after[k].float() - v.float()))
            for k, v in before.items()}


@contextlib.contextmanager
def first_images(trainer_cls, out: Dict[str, Any], on: bool = True):
    """While in the block, the trainable images of the trainer's first
    ``_images`` call go to ``out["images"]`` as uint8 [N, H, W, C]: the
    generator's answer inside the step."""
    if not on:
        yield
        return
    orig = trainer_cls._images

    def images(self, *args, **kwargs):
        frozen, trainable = orig(self, *args, **kwargs)
        out.setdefault("images", generate_ref.to_uint8(trainable.detach()))
        return frozen, trainable

    trainer_cls._images = images
    try:
        yield
    finally:
        trainer_cls._images = orig


def losses(values: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in values.items()}


def follow(c: Dict[str, Any], t: Dict[str, Any], seed: int, inputs, device,
           precision: str = "float32", steps: int = 3) -> Dict[str, Any]:
    """The trainer's first ``steps`` steps as the reference computes them
    (``precision`` "float32", or "control": see ``train_ref.PRECISIONS``,
    and the CLIP tower's bf16 linear layers on fp8 operands):
    {"losses", "first" (Adam's moments after step 1), "change" (each
    offsets leaf's after the last)}."""
    g_params, ccfg, cparams, emb, offsets = inputs
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rounding = (conv2d_gradfix.control_rounding() if precision == "control"
                else contextlib.nullcontext())
    try:
        cfg = trainer_config(t, "float32" if precision == "float32"
                             else "bfloat16")
        g_cfg = generate_ref.g_config(c, precision)
        trainer = ad.AdaptationTrainer(
            cfg, g_cfg, g_params, {n: (ccfg, cparams) for n in emb},
            Rng(seed), emb, device=device, offsets=offsets)
        before = offsets_snapshot(trainer.offsets)
        out: Dict[str, Any] = {"losses": []}
        with rounding:
            for i in range(steps):
                with first_images(ad.AdaptationTrainer, out, i == 0):
                    out["losses"].append(losses(trainer.train_step_async()))
                if i == 0:
                    out["first"] = opt_norms(trainer.opt_state)
        out["change"] = change_norms(before, trainer.offsets)
        out["sizes"] = {k: v.numel() for k, v in before.items()}
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
