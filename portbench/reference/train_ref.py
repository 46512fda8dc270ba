"""The plain reference of the training cells: the first three batches of
the few-shot or whole-G ADA training loop, in float32 with TF32 off, on
the inputs that the program got: the benchmark's weights, the real
images, and each batch's latents and step key.

It builds its own networks from the configuration file's numbers with the
frozen copy (``frozen/``) and follows the loop's schedule (Greg every 4
batches, Dreg every 16, both at batch 0).  The weights are the
benchmark's (``make_weights``; the program resumes from them, written by
``write_snapshot``), so the reference does not depend on how the program
draws its own.  It returns, per leaf, the norms that the comparison
reads: the Adam moments after the first batch and the change of every
parameter, G_ema and ``pl_mean`` after the third.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Sequence

import numpy as np
import torch

from .frozen.models import stylegan2 as sg2
from .frozen.ops import conv2d_gradfix
from .frozen.params import offsets as offs_lib
from .frozen.train import augment as aug_lib
from .frozen.train import gan_loss
from .frozen.train import train_step as ts
from .frozen.utils.checkpoint import tree_to_flat_tensors
from .frozen.utils.rng import Rng

# Precisions the reference runs in: the plain reference ("float32", TF32
# off) and the control one precision below the configuration's
# ("control": the float32 blocks and linear layers in bf16, the bf16 blocks'
# convolutions on fp8 operands, the ADA pipe in bf16 as configured).
PRECISIONS = ("float32", "control")


def fp8_resolution(c: Dict[str, Any]) -> int:
    """The lowest resolution the configuration runs in bf16."""
    return max(2 ** (int(math.log2(c["img_resolution"])) + 1
                     - c["num_fp16_res"]), 8)


def configs(c: Dict[str, Any], t: Dict[str, Any], precision: str):
    """The frozen (g_cfg, d_cfg, train_cfg, augment_cfg) of the cell."""
    fp16_res = 0 if precision == "float32" else 99
    fp8_res = None if precision == "float32" else fp8_resolution(c)
    res = c["img_resolution"]
    g_cfg = sg2.GeneratorConfig(
        z_dim=c["z_dim"], w_dim=c["w_dim"], img_resolution=res,
        img_channels=c["img_channels"],
        mapping=sg2.MappingConfig(num_layers=c["mapping_layers"]),
        synthesis=sg2.SynthesisConfig(
            channel_base=c["channel_base"], channel_max=c["channel_max"],
            num_fp16_res=fp16_res, conv_clamp=c["conv_clamp"],
            fp8_resolution=fp8_res))
    main, greg, dreg = t["rounds"]
    d_cfg = sg2.DiscriminatorConfig(
        img_resolution=res, img_channels=c["img_channels"],
        channel_base=c["channel_base"], channel_max=c["channel_max"],
        num_fp16_res=fp16_res, conv_clamp=c["conv_clamp"],
        mbstd_group_size=c["mbstd_group_size"], fp8_resolution=fp8_res)
    opts = t.get("options", {})
    lr = c["lr"]
    train_cfg = ts.TrainConfig(
        g_lr=opts.get("glrate", lr), d_lr=opts.get("dlrate", lr),
        ema_kimg=c["ema_kimg"], ema_rampup=None, batch_size=t["batch"],
        accum_rounds=main, g_reg_accum_rounds=greg, d_reg_accum_rounds=dreg,
        loss=gan_loss.GANLossConfig(r1_gamma=c["r1_gamma"]),
        g_requires_grad_parts=tuple(opts.get(
            "generator_requires_grad_parts", "all").split(",")))
    aug_cfg = aug_lib.make_config(
        t["augpipe"], compute_dtype=None if precision == "float32"
        else "bfloat16")
    return g_cfg, d_cfg, train_cfg, aug_cfg


def _torch_generator(key) -> torch.Generator:
    return torch.Generator().manual_seed(int(key.randint((), 0, 2 ** 31 - 1)))


def make_weights(c: Dict[str, Any], t: Dict[str, Any], seed: int):
    """G's and D's weights (on the CPU), drawn from the seed by the init's
    rules.  The draws are those that the port's loop makes of its own
    today, so that readings taken before the weights were handed in
    stand."""
    g_cfg, d_cfg, _, _ = configs(c, t, "float32")
    k_g, k_d, _ = Rng(seed).split(3)
    return (sg2.init_generator(g_cfg, _torch_generator(k_g), "cpu"),
            sg2.init_discriminator(d_cfg, _torch_generator(k_d), "cpu"))


def write_snapshot(path: str, weights) -> str:
    """The weights as the port's network snapshot, which its training loop
    resumes from: an npz of ``G/<dotted key>`` and ``D/<dotted key>``
    arrays and an empty ``__config__``."""
    arrays = {f"{tag}/{k}": v.detach().cpu().numpy()
              for tag, tree in zip(("G", "D"), weights)
              for k, v in tree_to_flat_tensors(tree).items()}
    arrays["__config__"] = np.frombuffer(b"{}", dtype=np.uint8)
    np.savez(path, **arrays)
    return path


def draws(seed: int, batch: int, z_dim: int, n: int = 3):
    """``n`` batches' latents and step keys from the seed, for a run with
    no program to take them from (the control): [(z, key seed)]."""
    key, out = Rng(seed), []
    for _ in range(n):
        key, k_z, k_step = key.split(3)
        out.append((k_z.normal((batch, z_dim)), k_step.seed))
    return out


def _norms(tree: Dict[str, torch.Tensor], prefix: str) -> Dict[str, float]:
    return {prefix + k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tree.items()}


def leaf_norms_after_first(state, offsets_on: bool) -> Dict[str, float]:
    """Per leaf: the first moment (with beta1 0, the last gradient the
    optimizer took) and the root of the second moment, after batch 1."""
    out = {}
    for tag, opt in (("G", state.g_opt_state), ("D", state.d_opt_state),
                     ("O", state.offsets_opt_state if offsets_on else None)):
        if opt is None:
            continue
        out.update(_norms(opt.mu, f"mu/{tag}/"))
        out.update(_norms({k: v.sqrt() for k, v in opt.nu.items()},
                          f"rootnu/{tag}/"))
    return out


def snapshot(state) -> Dict[str, torch.Tensor]:
    """Clones of every leaf that a step can change."""
    flat = {}
    for tag, tree in (("G", state.g_params), ("D", state.d_params),
                      ("E", state.g_ema), ("O", state.offsets)):
        if tree is not None:
            flat.update({f"{tag}/{k}": v.detach().clone()
                         for k, v in tree_to_flat_tensors(tree).items()})
    flat["pl_mean"] = state.pl_mean.detach().float().clone().reshape(1)
    return flat


def change_norms(before: Dict[str, torch.Tensor], state) -> Dict[str, float]:
    """Per leaf, the norm of its change since ``before``."""
    after = snapshot(state)
    return {k: float(torch.linalg.vector_norm((after[k].float()
                                               - v.float())))
            for k, v in before.items()}


def sizes(flat: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Each leaf's element count, by the keys of ``snapshot`` and without
    the tag for the optimizer's."""
    out = {k: v.numel() for k, v in flat.items()}
    out.update({k[2:]: v.numel() for k, v in flat.items() if k[1] == "/"})
    return out


@contextlib.contextmanager
def d_outputs(model_module, out: Dict[str, Any], on: bool = True):
    """While in the block, every output of ``discriminator_apply`` (the
    per-sample logits, in call order) goes to ``out["logits"]``."""
    if not on:
        yield
        return
    orig = model_module.discriminator_apply
    logits = out.setdefault("logits", [])

    def apply(*args, **kwargs):
        y = orig(*args, **kwargs)
        logits.append(y.detach().float().cpu().clone())
        return y

    model_module.discriminator_apply = apply
    try:
        yield
    finally:
        model_module.discriminator_apply = orig


LOSS_KEYS = ("Loss/G/loss", "Loss/D/loss", "Loss/G/reg", "Loss/D/reg")


def losses(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(metrics[k]) for k in LOSS_KEYS if k in metrics}


def follow(c: Dict[str, Any], t: Dict[str, Any], weights,
           inputs: Sequence, reals: Sequence[torch.Tensor], device,
           precision: str = "float32") -> Dict[str, Any]:
    """The loop's first batches from ``weights`` (``make_weights``), one a
    pair of ``inputs`` ((z, step key seed), as the program's step got them)
    and of ``reals`` (uint8 [N, C, H, W]), as the reference computes them:
    {"losses": [per batch],
    "logits": D's per-sample outputs in batch 1, "first": norms after
    batch 1, "change": norms of the change after the last}."""
    if precision not in PRECISIONS:
        raise ValueError(precision)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rounding = (conv2d_gradfix.control_rounding() if precision == "control"
                else contextlib.nullcontext())
    try:
        with rounding:
            return _follow(c, t, weights, inputs, reals, device, precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _follow(c, t, weights, inputs, reals, device, precision):
    g_cfg, d_cfg, cfg, aug_cfg = configs(c, t, precision)
    opts = t.get("options", {})
    g_params, d_params = (sg2.tree_map(lambda v: v.to(device, copy=True), w)
                          for w in weights)
    spec = offsets_tx = None
    parametrization = (opts.get("domain_modulation_parametrization")
                       if opts.get("use_domain_modulation") else None)
    parts = cfg.g_requires_grad_parts
    if parametrization:
        spec = offs_lib.OffsetsSpec.from_string(parametrization,
                                                weight_parts=parts)
        # Zeros for the mixes' parametrizations: no draw reaches them.
        offsets = offs_lib.init_offsets(Rng(0), g_cfg.synthesis, spec, device)
        offsets_tx = ts.build_offsets_optimizer(cfg, spec, offsets, parts)
    g_tx, d_tx, _, _ = ts.build_optimizers(cfg, g_params, d_params)
    state = ts.init_train_state(cfg, g_params, d_params, g_tx, d_tx)
    if spec is not None:
        ts.init_offsets_state(state, offsets, offsets_tx)
    state.ada_p = torch.tensor(float(t["initial_ada_p"]), dtype=torch.float32,
                               device=device)
    augment_fn = aug_lib.make_augment_fn(aug_cfg)
    r1_d_cfg = (dataclasses.replace(d_cfg, remat=True) if t.get("reg_remat")
                else None)
    steps = {}
    for do_g in (False, True):
        for do_d in (False, True):
            steps[(do_g, do_d)] = ts.make_fused_step(
                cfg, g_cfg, d_cfg, g_tx, d_tx, augment_fn=augment_fn,
                do_g_reg=do_g, do_d_reg=do_d,
                reg_d_cfg=r1_d_cfg if do_d else None, offsets_spec=spec,
                offsets_tx=offsets_tx)
    before = snapshot(state)
    out: Dict[str, Any] = {"losses": []}
    for i, ((z, k_step), real) in enumerate(zip(inputs, reals)):
        z, k_step = z.to(device), Rng(k_step)
        real = real.to(device).to(torch.float32) / 127.5 - 1.0
        variant = (i % cfg.g_reg_interval == 0, i % cfg.d_reg_interval == 0)
        with d_outputs(sg2, out, i == 0):
            state, metrics = steps[variant](state, real, None, z, None,
                                            k_step)
        out["losses"].append(losses(metrics))
        if i == 0:
            out["first"] = leaf_norms_after_first(state, spec is not None)
    out["change"] = change_norms(before, state)
    out["sizes"] = sizes(before)
    del state, before, steps
    return out
