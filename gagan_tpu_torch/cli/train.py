"""Adversarial (few-shot ADA) training CLI (port of gagan_tpu/cli/train.py).

    python -m gagan_tpu_torch.cli.train --outdir runs/ffhq --data <folder of PNGs>
        [--cfg auto] [--batch 32] [--kimg 25000] [--aug ada] [--device cuda]

The options, their defaults and choices are the JAX command's, flag for
flag, plus ``--device``.  :func:`build_run` turns a dataset's shape and the
options into the run's G, D, train, augment and loop configs and the memory
plan (accumulation rounds, remat), as the JAX command does; the generator
routes its eligible levels to the fused kernel (``pallas_level=True``).
A ``.zip`` is read by the C++ batch decoder (:class:`NativeZipDataset`)
when its library builds and the zip's first image decodes, as the JAX
command prefers it; otherwise, and for a folder, by
:class:`ImageFolderDataset`.  The command prints which loader it took.

``--use-domain-modulation --domain-modulation-parametrization P`` trains an
offsets tree of grammar P (few-shot domain adaptation, e.g.
``out_in_additive``: Affine+) with the G parts that
``--generator-requires-grad-parts`` names, and writes the offsets' EMA as
``adaptation-NNNNNN.npz`` beside every network snapshot.

``--gpus N`` (default: every visible card) trains data-parallel: the
command spawns N ranks, one card each, over NCCL (``--device cpu``: N CPU
ranks over gloo), as the reference's ``train.py`` does; each reads its share
of every batch and only rank 0 writes files.  Started by ``torchrun``
(``RANK`` / ``WORLD_SIZE`` set), the process joins that group instead.
``--gpus 1`` trains in this process.  The plan is the JAX command's for N
devices: ``--cfg auto``'s batch and mbstd group, and rounds of the
per-device batch.

``--spatial-shard-min-res R`` with several ranks (``--gpus N``,
``torchrun``, or ``--device cpu`` over gloo) shards the height of every
map at res >= R over the ranks instead of the batch
(``parallel/spatial.py``): each rank reads the whole batch and holds its
rows of the large maps.  With one rank it does nothing, as in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..data import ImageFolderDataset
from ..data import native_loader as nl
from ..models import stylegan2 as sg2
from ..parallel import mesh as mesh_lib
from ..train import augment as aug_lib
from ..train import gan_loss
from ..train import loop as loop_lib
from ..train import train_step as ts

CFG_SPECS = {
    "auto": dict(kimg=25000, mb=-1, mbstd=-1, lrate=-1, gamma=-1, ema=-1,
                 ramp=0.05, map=2, fmaps=-1),
    "stylegan2": dict(kimg=25000, mb=32, mbstd=4, lrate=0.002, gamma=10,
                      ema=10, ramp=None, map=8, fmaps=1),
    "paper256": dict(kimg=25000, mb=64, mbstd=8, lrate=0.0025, gamma=1,
                     ema=20, ramp=None, map=8, fmaps=0.5),
    "paper512": dict(kimg=25000, mb=64, mbstd=8, lrate=0.0025, gamma=0.5,
                     ema=20, ramp=None, map=8, fmaps=1),
    "paper1024": dict(kimg=25000, mb=32, mbstd=4, lrate=0.002, gamma=2,
                      ema=10, ramp=None, map=8, fmaps=1),
    "cifar": dict(kimg=100000, mb=64, mbstd=32, lrate=0.0025, gamma=0.01,
                  ema=500, ramp=0.05, map=2, fmaps=1),
}


@dataclasses.dataclass(frozen=True)
class Run:
    """Everything a training run is configured with."""
    g_cfg: sg2.GeneratorConfig
    d_cfg: sg2.DiscriminatorConfig
    train_cfg: ts.TrainConfig
    augment_cfg: Optional[aug_lib.AugmentConfig]
    loop_cfg: loop_lib.LoopConfig
    spec: Dict[str, Any]
    parts: Tuple[str, ...]
    schedule: str
    accum_rounds: Tuple[int, Optional[int], Optional[int]]
    main_remat: bool
    reg_remat: bool
    parametrization: Optional[str] = None    # offsets grammar, or None
    spatial_shard_min_res: Optional[int] = None

    def plan(self) -> Dict[str, Any]:
        """The plan the command prints (the JAX command's JSON)."""
        return {"spec": self.spec, "parts": self.parts,
                "schedule": self.schedule,
                "accum_rounds": list(self.accum_rounds)}


def rounds_for(device_batch: int, cap: int) -> int:
    """The fewest rounds that divide the batch with at most ``cap`` live
    samples each."""
    r = -(-device_batch // cap)
    while device_batch % r:
        r += 1
    return r


def build_run(res: int, num_channels: int = 3, label_dim: int = 0, *,
              outdir: str = "runs/exp", n_devices: Optional[int] = None,
              cfg: str = "auto", kimg: Optional[int] = None,
              batch: Optional[int] = None, batch_gpu: Optional[int] = None,
              gamma: Optional[float] = None, cond: bool = False,
              aug: str = "ada", aug_p: Optional[float] = None,
              target: float = 0.6, augpipe: str = "bgc",
              aug_dtype: str = "auto", resume: Optional[str] = None,
              freezed: int = 0, lrate: Optional[float] = None,
              glrate: Optional[float] = None, dlrate: Optional[float] = None,
              use_domain_modulation: bool = False,
              domain_modulation_parametrization: Optional[str] = None,
              generator_requires_grad_parts: str = "all", snap: int = 50,
              seed: int = 0, phase_schedule: str = "simultaneous",
              packed_tail_blocks: int = 1, packed_head_blocks: int = 1,
              ga_threshold: Optional[float] = None,
              ga_mutation_rate: float = 0.1,
              spatial_shard_min_res: Optional[int] = None) -> Run:
    """The configs and memory plan of a run on ``res``^2 images with
    ``num_channels`` channels over ``n_devices`` (default 1) data-parallel
    ranks, from the command's options."""
    spec = dict(CFG_SPECS[cfg])
    n_dev = n_devices or 1
    if cfg == "auto":
        spec["mb"] = max(min(n_dev * min(4096 // res, 32), 64), n_dev)
        spec["mbstd"] = min(spec["mb"] // n_dev, 4)
        spec["fmaps"] = 1 if res >= 512 else 0.5
        spec["lrate"] = 0.002 if res >= 1024 else 0.0025
        spec["gamma"] = 0.0002 * (res ** 2) / spec["mb"]
        spec["ema"] = spec["mb"] * 10 / 32
    if kimg is not None:
        spec["kimg"] = kimg
    if batch is not None:
        spec["mb"] = batch
    if gamma is not None:
        spec["gamma"] = gamma
    if lrate is not None:
        spec["lrate"] = lrate
    spec["glrate"] = glrate if glrate is not None else spec["lrate"]
    spec["dlrate"] = dlrate if dlrate is not None else spec["lrate"]

    # batch_gpu < batch => sequential gradient-accumulation rounds.  At
    # 1024^2 the live batch is capped at 8 (simultaneous main phases and
    # R1) and 16 (alternating main phases, Greg), the JAX package's plan.
    device_batch = max(spec["mb"] // n_dev, 1)
    accum_rounds = 1
    g_reg_rounds = d_reg_rounds = None
    if batch_gpu is not None:
        if device_batch % batch_gpu:
            raise ValueError(
                f"--batch-gpu={batch_gpu} must divide the per-device batch "
                f"{device_batch} (= batch {spec['mb']} / {n_dev} devices)")
        accum_rounds = device_batch // batch_gpu
    elif res >= 1024:
        main_cap = 8 if phase_schedule == "simultaneous" else 16
        accum_rounds = rounds_for(device_batch, main_cap)
        g_reg_rounds = rounds_for(device_batch, 16)
        d_reg_rounds = rounds_for(device_batch, 8)

    g_parts = tuple(generator_requires_grad_parts.split(","))

    # At 1024^2 the capped live batch lets the hot variants run without
    # remat; only the R1 phase gets a remat'd D.  At 512 the live batch is
    # uncapped, so G and D remat every block.
    main_remat = (res == 512) or (res >= 1024
                                  and device_batch // accum_rounds > 16)
    reg_remat = res >= 1024 and not main_remat
    c_dim = label_dim if cond else 0
    g_cfg = sg2.GeneratorConfig(
        z_dim=512, w_dim=512, c_dim=c_dim, img_resolution=res,
        img_channels=num_channels,
        mapping=sg2.MappingConfig(num_layers=spec["map"]),
        synthesis=sg2.SynthesisConfig(
            channel_base=int(spec["fmaps"] * 32768), channel_max=512,
            num_fp16_res=4, conv_clamp=256,
            packed_last_block=(res >= 64 and packed_tail_blocks > 0),
            packed_tail_blocks=max(packed_tail_blocks, 1),
            remat=main_remat, pallas_level=True))
    d_cfg = sg2.DiscriminatorConfig(
        c_dim=c_dim, img_resolution=res, img_channels=num_channels,
        channel_base=int(spec["fmaps"] * 32768), channel_max=512,
        num_fp16_res=4, conv_clamp=256, mbstd_group_size=spec["mbstd"],
        packed_first_block=(res >= 64 and packed_head_blocks > 0),
        packed_head_blocks=max(packed_head_blocks, 1), remat=main_remat)

    train_cfg = ts.TrainConfig(
        g_lr=spec["glrate"], d_lr=spec["dlrate"],
        ema_kimg=spec["ema"], ema_rampup=spec["ramp"],
        ada_target=(target if aug == "ada" else None),
        batch_size=spec["mb"],
        accum_rounds=accum_rounds,
        g_reg_accum_rounds=g_reg_rounds,
        d_reg_accum_rounds=d_reg_rounds,
        loss=gan_loss.GANLossConfig(r1_gamma=spec["gamma"]),
        g_requires_grad_parts=g_parts,
        freeze_d_layers=freezed,
        simultaneous_main=(phase_schedule == "simultaneous"),
        ga_threshold=ga_threshold,
        ga_mutation_rate=ga_mutation_rate)

    augment_cfg = None
    if aug != "noaug":
        # 'auto': a bf16 pipe where the D's high-res blocks are bf16 anyway.
        if aug_dtype == "auto":
            compute_dtype = "bfloat16" if res >= 256 else None
        else:
            compute_dtype = None if aug_dtype == "float32" else aug_dtype
        augment_cfg = aug_lib.make_config(augpipe,
                                          compute_dtype=compute_dtype)

    loop_cfg = loop_lib.LoopConfig(
        run_dir=outdir, total_kimg=spec["kimg"], random_seed=seed,
        n_devices=n_devices, image_snapshot_ticks=snap,
        network_snapshot_ticks=snap, resume_from=resume,
        initial_ada_p=(aug_p or 0.0) if aug == "fixed" else 0.0)
    return Run(g_cfg, d_cfg, train_cfg, augment_cfg, loop_cfg, spec, g_parts,
               phase_schedule, (accum_rounds, g_reg_rounds, d_reg_rounds),
               main_remat, reg_remat,
               domain_modulation_parametrization if use_domain_modulation
               else None, spatial_shard_min_res)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Train a StyleGAN2 model on CUDA cards (PyTorch port).")
    add = ap.add_argument
    add("--outdir", required=True, metavar="DIR")
    add("--data", required=True, help="Training dataset (dir or zip)")
    add("--gpus", dest="n_devices", type=int, default=None,
        help="Number of data-parallel ranks, one card each (default: every "
             "visible card; with --device cpu, CPU ranks over gloo)")
    add("--cfg", choices=list(CFG_SPECS), default="auto")
    add("--kimg", type=int, default=None)
    add("--batch", type=int, default=None)
    add("--batch-gpu", type=int, default=None,
        help="Samples held live at once; smaller than the batch turns on "
             "gradient accumulation")
    add("--gamma", type=float, default=None, help="R1 gamma override")
    add("--cond", action="store_true", help="Train conditional model")
    add("--mirror", action="store_true", help="Enable dataset x-flips")
    add("--subset", type=int, default=None, help="Use only N images")
    add("--aug", choices=["noaug", "ada", "fixed"], default="ada")
    add("--p", dest="aug_p", type=float, default=None,
        help="Probability for --aug=fixed")
    add("--target", type=float, default=0.6)
    add("--augpipe", default="bgc")
    add("--aug-dtype", choices=["auto", "float32", "bfloat16"],
        default="auto", help="Augment-pipe compute dtype; 'auto' picks "
                             "bfloat16 at res>=256, float32 below")
    add("--resume", default=None, help="Snapshot .npz to resume from")
    add("--freezed", type=int, default=0, help="Freeze-D layers")
    add("--lrate", type=float, default=None)
    add("--glrate", type=float, default=None)
    add("--dlrate", type=float, default=None)
    add("--use-domain-modulation", action="store_true")
    add("--domain-modulation-parametrization", default=None)
    add("--generator-requires-grad-parts", default="all",
        help="Comma-separated parts grammar")
    add("--snap", type=int, default=50, help="Snapshot interval in ticks")
    add("--seed", type=int, default=0)
    add("--phase-schedule", choices=["simultaneous", "alternating"],
        default="simultaneous")
    add("--packed-tail-blocks", type=int, default=1)
    add("--packed-head-blocks", type=int, default=1)
    add("--ga-threshold", type=float, default=None)
    add("--ga-mutation-rate", type=float, default=0.1)
    add("--spatial-shard-min-res", type=int, default=None,
        help="Shard the rows of every map at res >= this over the ranks "
             "(spatial sharding) instead of the batch")
    add("--dry-run", action="store_true")
    add("--device", default="cuda",
        help="torch device (default cuda; cpu runs the plain PyTorch "
             "versions of the kernels)")
    return ap


def open_dataset(data: str, **kw):
    """The training data and a line saying which loader reads it: for a
    ``.zip``, :class:`NativeZipDataset` when the native library builds and
    opens the zip (GIL-free PNG decode threads), else
    :class:`ImageFolderDataset`, as ``gagan_tpu/cli/train.py`` picks."""
    why = ""
    if data.endswith(".zip"):
        if nl.native_available():
            try:
                return (nl.NativeZipDataset(data, **kw),
                        f"Loader: NativeZipDataset (C++ batch decode) for "
                        f"{data}")
            except IOError as e:
                why = f" (the native loader refused the zip: {e})"
        else:
            why = f" (the native loader did not build: {nl.build_error()})"
    return (ImageFolderDataset(data, **kw),
            f"Loader: ImageFolderDataset for {data}{why}")


def world_size(n_devices: Optional[int], device) -> int:
    """The ranks a run takes: ``torchrun``'s world, ``--gpus``, or every
    visible card (one on the CPU).  Refuses more ranks than visible
    cards."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    if torch.device(device).type != "cuda":
        return n_devices or 1
    visible = torch.cuda.device_count()
    if n_devices is None:
        return max(visible, 1)
    if n_devices > max(visible, 1):
        raise ValueError(f"--gpus {n_devices} asks for {n_devices} cards, "
                         f"but {visible} CUDA device(s) are visible")
    return n_devices


def main(argv: Optional[List[str]] = None):
    """Parse, configure, print the plan, then train (unless --dry-run).
    Returns the final train state of a run in this process; None for a dry
    run or a run over spawned ranks."""
    ap = build_parser()
    args = vars(ap.parse_args(argv))
    data, mirror, subset = args.pop("data"), args.pop("mirror"), args.pop(
        "subset")
    dry_run, device = args.pop("dry_run"), args.pop("device")
    dataset, loader_line = open_dataset(
        data, use_labels=args["cond"], xflip=mirror, max_size=subset,
        random_seed=args["seed"])
    try:
        args["n_devices"] = world_size(args["n_devices"], device)
        run = build_run(dataset.resolution, dataset.num_channels,
                        dataset.label_dim if args["cond"] else 0, **args)
    except ValueError as e:
        ap.error(str(e))

    desc = f"{dataset.name}-{args['cfg']}-b{run.spec['mb']}"
    if args["use_domain_modulation"]:
        desc += f"-dm-{args['domain_modulation_parametrization']}"
    print(f"Run: {desc}")
    print(json.dumps(run.plan(), indent=2, default=str))
    if dry_run:
        print("Dry run; exiting.")
        return None
    print(loader_line)
    n = args["n_devices"]
    on_cpu = torch.device(device).type == "cpu"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        mesh = mesh_lib.create_mesh(n, device="cpu" if on_cpu else None)
        return _train(run, dataset, mesh)
    if n == 1:
        return _train(run, dataset, mesh_lib.create_mesh(1, device=device))
    if not on_cpu:
        from .. import _build

        _build.build_all()       # once, before the ranks load it
    dataset.close()
    mesh_lib.spawn(_train_rank, n, devices="cpu" if on_cpu else None,
                   args=(data, dict(use_labels=args["cond"], xflip=mirror,
                                    max_size=subset,
                                    random_seed=args["seed"]), args))
    return None


def _train(run: Run, dataset, mesh):
    return loop_lib.training_loop(
        run.loop_cfg, run.train_cfg, run.g_cfg, run.d_cfg, dataset,
        augment_cfg=run.augment_cfg, parametrization=run.parametrization,
        weight_parts=run.parts, reg_remat=run.reg_remat,
        spatial_shard_min_res=run.spatial_shard_min_res, mesh=mesh)


def _train_rank(mesh, data: str, data_kw: Dict[str, Any],
                args: Dict[str, Any]) -> None:
    """One spawned rank of ``main``: the dataset opened again, the same
    run, the loop on this rank's mesh."""
    dataset, _ = open_dataset(data, **data_kw)
    run = build_run(dataset.resolution, dataset.num_channels,
                    dataset.label_dim if args["cond"] else 0, **args)
    _train(run, dataset, mesh)


if __name__ == "__main__":
    main()
