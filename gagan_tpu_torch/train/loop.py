"""The adversarial training loop (port of gagan_tpu/train/loop.py).

Host-side scheduling of the step variants (lazy-reg interval gating),
tick-cadenced status lines and ``stats.jsonl``, image grids and network
snapshots, the ADA p heuristic, abort polling, resume from a snapshot of
either package, and an optional metrics hook.  Draws come from one root
draw source on the JAX loop's key tree (``utils/rng.py``): the networks'
init keys, the offsets' key (with a ``parametrization``), the grid latents,
then per batch a latent key and a step key.

With a ``parametrization`` (few-shot domain adaptation, ``cli/train.py
--use-domain-modulation``) the G phases also train an offsets tree
(params/offsets.py) on its own Adam, and every network snapshot comes with
an ``adaptation-NNNNNN.npz`` of the offsets' EMA.  As in the JAX loop, the
snapshot grid is drawn from G_ema without the offsets.

A :class:`~gagan_tpu_torch.data.native_loader.NativeZipDataset` is read
by its C++ batch decoder (``native_data_loader``), any other dataset by the
threaded ``data_loader``, as in the JAX loop.

Data parallelism: run in each rank of a process group (``mesh``, or
``parallel.mesh.create_mesh(loop_cfg.n_devices)``), the loop builds the
same state from the same seeds and replicates rank 0's, reads only the
rank's share of each global batch, and steps with the sharded step; only
rank 0 writes files and runs ``metrics_fn`` and ``progress_fn`` (the others
wait), rank 0's ``abort_fn`` decides for all, and the parameters are
checked equal across ranks before each network snapshot.

Spatial sharding (``spatial_shard_min_res``, as the JAX loop takes it):
over a mesh of several ranks, every rank reads the whole global batch and
steps with ``parallel.spatial``'s hooks (the synthesis layers at res >=
``spatial_shard_min_res``) and D constraint, holding the large maps' rows
only; the step is not bound to the mesh.  Rank 0 writes, as above.  In a
world of one the option does nothing, as in JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data import native_loader as nl
from ..data.dataset import data_loader
from ..models import stylegan2 as sg2
from ..parallel import mesh as mesh_lib
from ..parallel import spatial as spatial_lib
from ..params import offsets as offs_lib
from ..utils import checkpoint as ckpt
from ..utils import config as config_lib
from ..utils.observability import trace_scope
from ..utils.png import write_png
from ..utils.rng import Rng
from ..utils.stats import Collector, StatsLogger
from . import augment as aug
from . import train_step as ts


@dataclasses.dataclass
class LoopConfig:
    run_dir: str = "runs/exp"
    total_kimg: float = 25000
    kimg_per_tick: float = 4
    image_snapshot_ticks: Optional[int] = 50
    network_snapshot_ticks: Optional[int] = 50
    random_seed: int = 0
    n_devices: Optional[int] = None
    grid_size: Tuple[int, int] = (4, 4)
    resume_from: Optional[str] = None   # snapshot npz to resume params from
    initial_ada_p: float = 0.0          # for --aug=fixed
    metrics_fn: Optional[Callable] = None  # called with (g_ema_params, g_cfg)
    abort_fn: Optional[Callable[[], bool]] = None
    progress_fn: Optional[Callable[[int, int], None]] = None
    # Per-parameter TensorBoard histograms each tick.
    log_param_histograms: bool = True


def save_image_grid(img: np.ndarray, fname: str, drange, grid_size):
    """[N, C, H, W] images in ``drange`` -> one PNG grid of grid_size
    (columns, rows); gray for one channel."""
    lo, hi = drange
    img = np.asarray(img, dtype=np.float32)
    img = (img - lo) * (255 / (hi - lo))
    img = np.rint(img).clip(0, 255).astype(np.uint8)
    gw, gh = grid_size
    _n, c, h, w = img.shape
    img = img[: gw * gh].reshape(gh, gw, c, h, w)
    img = img.transpose(0, 3, 1, 4, 2).reshape(gh * h, gw * w, c)
    write_png(fname, img[:, :, 0] if c == 1 else img)


def _torch_generator(key) -> torch.Generator:
    """A CPU generator seeded from a draw of ``key`` (weight init)."""
    seed = int(key.randint((), 0, 2 ** 31 - 1))
    return torch.Generator().manual_seed(seed)


def _merge(dst, src):
    """Copy ``src`` leaves into ``dst`` by name, skipping missing keys and
    shape mismatches."""
    for k, v in src.items():
        if k in dst:
            if isinstance(v, dict):
                _merge(dst[k], v)
            elif tuple(dst[k].shape) == tuple(v.shape):
                dst[k] = v.to(device=dst[k].device, dtype=dst[k].dtype)


def training_loop(
    loop_cfg: LoopConfig,
    train_cfg: ts.TrainConfig,
    g_cfg: sg2.GeneratorConfig,
    d_cfg: sg2.DiscriminatorConfig,
    dataset,
    augment_cfg: Optional[aug.AugmentConfig] = None,
    parametrization: Optional[str] = None,
    weight_parts: Tuple[str, ...] = ("all",),
    reg_remat: bool = False,
    spatial_shard_min_res: Optional[int] = None,
    device="cuda",
    rng=None,
    mesh: Optional[mesh_lib.Mesh] = None,
) -> ts.TrainState:
    """Train until ``loop_cfg.total_kimg``; returns the final state.

    ``device`` is the card (default) or 'cpu'; ``rng`` is the root draw
    source (default ``Rng(loop_cfg.random_seed)``; anything with the
    ``Rng`` methods, e.g. JAX's key tree in the tests).  ``mesh``: this
    rank's mesh (default: ``create_mesh(loop_cfg.n_devices)``, a world of
    one outside a process group); its device replaces ``device``.
    ``spatial_shard_min_res``: spatial sharding over the mesh's ranks
    (module docstring)."""
    if mesh is None:
        mesh = mesh_lib.create_mesh(loop_cfg.n_devices,
                                    device=resolve_device(device))
    elif loop_cfg.n_devices not in (None, mesh.world_size):
        raise ValueError(f"n_devices={loop_cfg.n_devices} on a mesh of "
                         f"{mesh.world_size}")
    device = mesh.device
    lead = mesh.rank == 0
    run_dir = loop_cfg.run_dir
    if lead:
        os.makedirs(run_dir, exist_ok=True)
    key = rng if rng is not None else Rng(loop_cfg.random_seed)

    # Networks.
    k_g, k_d, key = key.split(3)
    g_params = sg2.init_generator(g_cfg, _torch_generator(k_g), device)
    d_params = sg2.init_discriminator(d_cfg, _torch_generator(k_d), device)
    trees = {}
    if loop_cfg.resume_from:
        trees, _cfg = ckpt.load_snapshot(loop_cfg.resume_from, device=device)
        if "G" in trees:
            _merge(g_params, trees["G"])
        if "D" in trees:
            _merge(d_params, trees["D"])

    # The offsets parameterization (domain adaptation).
    offsets_spec = offsets_tx = None
    if parametrization:
        offsets_spec = offs_lib.OffsetsSpec.from_string(
            parametrization, weight_parts=weight_parts)
        key, k_off = key.split(2)
        offsets = offs_lib.init_offsets(k_off, g_cfg.synthesis, offsets_spec,
                                        device)
        offsets_tx = ts.build_offsets_optimizer(train_cfg, offsets_spec,
                                                offsets, weight_parts)

    g_tx, d_tx, _gm, _dm = ts.build_optimizers(train_cfg, g_params, d_params)
    state = ts.init_train_state(train_cfg, g_params, d_params, g_tx, d_tx)
    if offsets_spec is not None:
        ts.init_offsets_state(state, offsets, offsets_tx)
    if "G_ema" in trees:
        _merge(state.g_ema, trees["G_ema"])
    if loop_cfg.initial_ada_p:
        state.ada_p = torch.tensor(loop_cfg.initial_ada_p, dtype=torch.float32,
                                   device=device)
    mesh_lib.place_state(mesh, state)

    augment_fn = aug.make_augment_fn(augment_cfg) if augment_cfg else None

    # Step variants keyed by (do_g_reg, do_d_reg).  reg_remat: only the R1
    # phase runs a remat'd D (its double backward sets the memory peak).
    # The fused level is differentiable once, so the path-length phase runs
    # with pallas_level off.
    r1_d_cfg = dataclasses.replace(d_cfg, remat=True) if reg_remat else None
    pl_g_cfg = None
    if g_cfg.synthesis.pallas_level:
        pl_g_cfg = dataclasses.replace(
            g_cfg, synthesis=dataclasses.replace(
                g_cfg.synthesis, pallas_level=False))
    # Spatial sharding: hooks and a D constraint over the mesh, and a step
    # that every rank runs on the whole batch.
    extra_hooks = d_constraint = None
    spatial = (spatial_shard_min_res is not None and mesh.sharded
               and mesh.world_size > 1)
    if spatial:
        extra_hooks = spatial_lib.spatial_sharding_hooks(
            g_cfg.synthesis, mesh, min_res=spatial_shard_min_res)
        d_constraint = spatial_lib.d_spatial_constraint(mesh)
    steps = {}
    for do_g in (False, True):
        for do_d in (False, True):
            step = ts.make_fused_step(
                train_cfg, g_cfg, d_cfg, g_tx, d_tx, augment_fn=augment_fn,
                do_g_reg=do_g, do_d_reg=do_d,
                reg_g_cfg=pl_g_cfg if do_g else None,
                reg_d_cfg=r1_d_cfg if do_d else None,
                offsets_spec=offsets_spec, offsets_tx=offsets_tx,
                extra_hooks=extra_hooks, d_constraint=d_constraint)
            steps[(do_g, do_d)] = (step if spatial else
                                   mesh_lib.shard_train_step(step, mesh))

    # Data: decoded by the loader's threads into pinned host memory when
    # the card is the target, then copied without blocking the host.  A
    # data-parallel rank reads only its rows of each global batch; a
    # spatially sharded one reads all of it.
    pin = None
    if device.type == "cuda":
        def pin(batch):
            return tuple(torch.from_numpy(a).pin_memory() for a in batch)
    rows = None
    if mesh.sharded and not spatial:
        rows = mesh_lib.share_rows(train_cfg.batch_size, mesh.world_size,
                                   mesh.rank, ts.data_rounds(train_cfg))
    if isinstance(dataset, nl.NativeZipDataset):
        loader = nl.native_data_loader(dataset, train_cfg.batch_size,
                                       seed=loop_cfg.random_seed,
                                       to_device=pin, rows=rows)
    else:
        loader = data_loader(dataset, train_cfg.batch_size,
                             seed=loop_cfg.random_seed, to_device=pin,
                             rows=rows)

    # Snapshot grid latents.
    grid_n = loop_cfg.grid_size[0] * loop_cfg.grid_size[1]
    key, k_grid = key.split(2)
    grid_z = k_grid.normal((grid_n, g_cfg.z_dim), device=device)

    def ema_synthesize(g_ema, z):
        with torch.no_grad():
            return sg2.generator_apply(g_cfg, g_ema, z, c=None,
                                       noise_mode="const")

    # The step's metrics are already means over the ranks.
    collector = Collector()
    logger = None
    if lead:
        logger = StatsLogger(run_dir)
        with open(os.path.join(run_dir, "training_options.json"), "wt") as f:
            json.dump({
                "loop": {k: str(v) for k, v in
                         dataclasses.asdict(loop_cfg).items()},
                "train": {k: str(v) for k, v in
                          dataclasses.asdict(train_cfg).items()},
            }, f, indent=2)

    start_time = time.time()
    cur_tick = 0
    tick_start_nimg = 0
    tick_start_time = start_time
    batch_idx = 0
    done = False

    while not done:
        with trace_scope("loop.next_batch"):
            images, labels = next(loader)
            images, labels = (torch.as_tensor(a).to(device, non_blocking=True)
                              for a in (images, labels))
        real = images.to(torch.float32) / 127.5 - 1.0
        real_c = labels if labels.shape[1] > 0 else None
        gen_c = real_c
        if real_c is not None and rows is not None:
            gen_c = mesh.gather(real_c, rows, train_cfg.batch_size)
        key, k_z, k_step = key.split(3)
        z = k_z.normal((train_cfg.batch_size, g_cfg.z_dim), device=device)

        do_g_reg = (train_cfg.g_reg_interval is not None
                    and batch_idx % train_cfg.g_reg_interval == 0)
        do_d_reg = (train_cfg.d_reg_interval is not None
                    and batch_idx % train_cfg.d_reg_interval == 0)
        with trace_scope("loop.step", device=True):
            state, metrics = steps[(do_g_reg, do_d_reg)](
                state, real, real_c, z, gen_c, k_step)
        collector.report_dict(metrics)
        batch_idx += 1
        cur_nimg = int(state.cur_nimg)

        # ADA heuristic.
        if (train_cfg.ada_target is not None
                and batch_idx % train_cfg.ada_interval == 0):
            with trace_scope("host_read.ada_p"):
                ada_p = float(state.ada_p)
            new_p = ts.ada_update(train_cfg, ada_p,
                                  collector.mean("Loss/signs/real"))
            state.ada_p = torch.tensor(new_p, dtype=torch.float32,
                                       device=device)

        done = cur_nimg >= loop_cfg.total_kimg * 1000
        if (not done) and (cur_nimg < tick_start_nimg
                           + loop_cfg.kimg_per_tick * 1000):
            continue

        # ---- Tick maintenance ----
        with trace_scope("loop.tick"):
            tick_end_time = time.time()
            with trace_scope("host_read.ada_p"):
                ada_p = float(state.ada_p)
            sec_per_kimg = ((tick_end_time - tick_start_time)
                            / max(cur_nimg - tick_start_nimg, 1) * 1000)
            fields = [
                f"tick {cur_tick:<5d}",
                f"kimg {cur_nimg / 1e3:<8.1f}",
                f"sec/tick {tick_end_time - tick_start_time:<7.1f}",
                f"sec/kimg {sec_per_kimg:<7.2f}",
                f"augment {ada_p:.3f}",
                f"G_loss {collector.mean('Loss/G/loss'):.3f}",
                f"D_loss {collector.mean('Loss/D/loss'):.3f}",
            ]
            if lead:
                print(" ".join(fields), flush=True)
                logger.write(collector, step=cur_nimg, extra={
                    "Progress/tick": cur_tick,
                    "Progress/kimg": cur_nimg / 1e3,
                    "Progress/augment": ada_p,
                    "Timing/sec_per_kimg": sec_per_kimg,
                    "Timing/total_sec": tick_end_time - start_time,
                })
                if loop_cfg.log_param_histograms:
                    logger.log_histograms({"G": state.g_params,
                                           "D": state.d_params}, step=cur_nimg)
            collector.reset()

            if loop_cfg.abort_fn is not None:
                abort = torch.tensor(
                    [float(lead and bool(loop_cfg.abort_fn()))], device=device)
                if not done:
                    with trace_scope("host_read.abort"):
                        done = bool(mesh.broadcast_(abort).item())
            if lead and loop_cfg.progress_fn is not None:
                loop_cfg.progress_fn(cur_nimg // 1000, loop_cfg.total_kimg)

            image_ticks = loop_cfg.image_snapshot_ticks
            if (lead and image_ticks is not None
                    and (done or cur_tick % image_ticks == 0)):
                imgs = ema_synthesize(state.g_ema, grid_z).cpu().numpy()
                save_image_grid(
                    imgs, os.path.join(run_dir,
                                       f"fakes{cur_nimg // 1000:06d}.png"),
                    drange=[-1, 1], grid_size=loop_cfg.grid_size)

            network_ticks = loop_cfg.network_snapshot_ticks
            snapshot = (network_ticks is not None
                        and (done or cur_tick % network_ticks == 0))
            if snapshot:
                mesh_lib.check_replica_consistency(state, "train state", mesh)
            if lead and snapshot:
                snap_path = os.path.join(
                    run_dir, f"network-snapshot-{cur_nimg // 1000:06d}.npz")
                ckpt.save_snapshot(
                    snap_path, g_params=state.g_params,
                    d_params=state.d_params, g_ema=state.g_ema,
                    config={"g_cfg": config_lib.to_dict(g_cfg),
                            "d_cfg": config_lib.to_dict(d_cfg)},
                    extra={"pl_mean": state.pl_mean, "ada_p": state.ada_p,
                           "cur_nimg": np.asarray(state.cur_nimg, np.int32)})
                if offsets_spec is not None:
                    ckpt.save_adaptation(
                        os.path.join(run_dir,
                                     f"adaptation-{cur_nimg // 1000:06d}.npz"),
                        model_type="parametrization",
                        parametrization=parametrization,
                        offsets=state.offsets_ema,
                        sg2_config=config_lib.to_dict(g_cfg))
                if loop_cfg.metrics_fn is not None:
                    loop_cfg.metrics_fn(state.g_ema, g_cfg, snapshot=snap_path)
            mesh.barrier()

            cur_tick += 1
            tick_start_nimg = cur_nimg
            tick_start_time = time.time()

    loader.close()
    if logger is not None:
        logger.close()
    return state
