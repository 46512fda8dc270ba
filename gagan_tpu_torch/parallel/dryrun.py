"""Rank workers of data-parallel dry runs (counterpart of
tools/dryrun_multiprocess.py): each is a module-level function
``fn(mesh, ...)`` for :func:`parallel.mesh.spawn`, so that spawned ranks
import the port and nothing else.

* :func:`step_rank`: the fused train step's scheduled variants, each from
  the same state, with the state's leaves, metrics, times and fused
  launches returned.
* :func:`basic_rank`: the ``basic`` protocol: two steps, the stats
  reduction, the rank-0 snapshot gate and cross-rank agreement.
* :func:`resume_rank`: the ``full`` / ``pre`` / ``resume`` protocol: four
  uninterrupted steps against two steps, a save on rank 0, a restore on
  every rank and two more steps.  The states must be bit-equal.
* :func:`multichip_rank` (``entry.dryrun_multichip``), and the workers of
  the CPU tests: ``minibatch_std`` and the ADA pipe on a rank's share
  (:func:`mbstd_rank`, :func:`augment_rank`), the GA with ``mesh=``
  (:func:`ga_rank`), the training loop (:func:`loop_rank`), the replica
  check (:func:`replica_check_rank`) and the modules a rank imports
  (:func:`modules_rank`); spatial sharding's (:func:`spatial_rank`: the
  sharded synthesis, D, the exchanges' adjoints and gradchecks, the step).

    python -m gagan_tpu_torch.parallel.dryrun [--ranks 2] [--device cpu]
        [--backend gloo]

runs both protocols (:func:`protocols_rank`) and prints ``dryrun ok``: on
cuda:0..N-1 over NCCL by default, on CPU ranks over gloo with ``--device
cpu``, or with every rank on one card (``--device cuda:0 --backend
gloo``).  Without a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..data import ImageFolderDataset
from ..ga.search import evolve_directions
from ..models import stylegan2 as sg2
from ..ops import fused_modconv as fmc
from ..params import offsets as offs_lib
from ..train import augment as aug
from ..train import train_step as ts
from ..train.loop import training_loop
from ..utils import checkpoint as ckpt
from ..utils.rng import Rng
from ..utils.stats import Collector
from . import mesh as mesh_lib
from . import spatial as spatial_lib


def tiny_configs(mbstd_group_size: int = 2, img_resolution: int = 32):
    """``__graft_entry__.dryrun_multichip``'s G and D: 32^2 (or
    ``img_resolution``), channel_base 1024, channel_max 64, two mapping
    layers, z and w of 32."""
    g_cfg = sg2.GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=img_resolution, img_channels=3,
        mapping=sg2.MappingConfig(num_layers=2),
        synthesis=sg2.SynthesisConfig(channel_base=1024, channel_max=64))
    d_cfg = sg2.DiscriminatorConfig(
        img_resolution=img_resolution, img_channels=3, channel_base=1024,
        channel_max=64, mbstd_group_size=mbstd_group_size)
    return g_cfg, d_cfg


@dataclasses.dataclass
class StepCase:
    """A fused step and its inputs, built on any rank: the configs, the
    initial weights (flat numpy, or None for G from seed 0 and D from seed
    1), the global batch (numpy) and the key (an ``Rng`` or anything with
    its methods that pickles)."""
    g_cfg: sg2.GeneratorConfig
    d_cfg: sg2.DiscriminatorConfig
    train_cfg: ts.TrainConfig
    real: np.ndarray
    z: np.ndarray
    key: Any
    weights: Optional[tuple] = None
    augment_cfg: Any = None
    ada_p: float = 0.0
    spatial_min_res: Optional[int] = None

    def build(self, mesh: Optional[mesh_lib.Mesh], device="cuda"):
        """(steps by variant, state, inputs) on ``mesh``, or in one process
        on ``device`` without one (the card unless 'cpu' is asked for);
        the steps are bound to the mesh.  With ``spatial_min_res`` the
        steps run spatially sharded over the mesh instead (every rank the
        whole batch, the steps not bound to it)."""
        device = mesh.device if mesh is not None else resolve_device(device)
        cfg = self.train_cfg
        if self.weights is None:
            g_params = sg2.init_generator(
                self.g_cfg, torch.Generator().manual_seed(0), device)
            d_params = sg2.init_discriminator(
                self.d_cfg, torch.Generator().manual_seed(1), device)
        else:
            g_params, d_params = (ckpt.flat_to_tree(w, device)
                                  for w in self.weights)
        g_tx, d_tx, _, _ = ts.build_optimizers(cfg, g_params, d_params)
        state = ts.init_train_state(cfg, g_params, d_params, g_tx, d_tx)
        state.ada_p = torch.tensor(float(self.ada_p), device=device)
        augment_fn = (aug.make_augment_fn(self.augment_cfg)
                      if self.augment_cfg is not None else None)
        spatial = mesh is not None and self.spatial_min_res is not None
        hooks = constraint = None
        if spatial:
            hooks = spatial_lib.spatial_sharding_hooks(
                self.g_cfg.synthesis, mesh, min_res=self.spatial_min_res)
            constraint = spatial_lib.d_spatial_constraint(mesh)
        steps = {}
        for name, do_g, do_d in VARIANTS:
            step = ts.make_fused_step(cfg, self.g_cfg, self.d_cfg, g_tx, d_tx,
                                      augment_fn=augment_fn, do_g_reg=do_g,
                                      do_d_reg=do_d, extra_hooks=hooks,
                                      d_constraint=constraint)
            steps[name] = (mesh_lib.shard_train_step(step, mesh)
                           if mesh is not None and not spatial else step)
        real = torch.from_numpy(self.real)
        real = (mesh_lib.shard_batch(mesh, real, ts.data_rounds(cfg))
                if mesh is not None and not spatial else real.to(device))
        z = torch.from_numpy(self.z).to(device)
        return steps, state, (real, None, z, None, self.key)


VARIANTS = (("none", False, False), ("greg", True, False),
            ("both", True, True))


def state_leaves(state) -> Dict[str, Any]:
    """The state's leaves by path, tensors copied to the CPU."""
    return {k: v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v
            for k, v in ckpt.train_state_leaves(state).items()}


def state_digest(state) -> str:
    """sha256 over every leaf's bytes, in path order."""
    h = hashlib.sha256()
    for k, v in sorted(ckpt.train_state_leaves(state).items()):
        h.update(k.encode())
        if isinstance(v, torch.Tensor):
            h.update(v.detach().reshape(-1).contiguous().cpu()
                     .view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_variants(mesh, steps, state, inputs, variants: Sequence[str],
                 keep: Callable = state_leaves):
    """Each variant once from a copy of ``state``: {variant: {"state":
    keep(state after), "metrics": floats, "s": seconds, "launches": fused
    launches}}.  With a sharded mesh the state is then checked to be
    bit-equal across ranks."""
    device = mesh.device if mesh is not None else inputs[2].device
    out = {}
    for name in variants:
        s = copy.deepcopy(state)
        fmc.fused_modconv3x3.launches = 0
        _sync(device)
        t0 = time.perf_counter()
        s, metrics = steps[name](s, *inputs)
        _sync(device)
        seconds = time.perf_counter() - t0
        launches = fmc.fused_modconv3x3.launches
        if mesh is not None:
            mesh_lib.check_replica_consistency(s, f"state after {name}",
                                               mesh)
        out[name] = {"state": keep(s),
                     "metrics": {k: v.detach().cpu().numpy()
                                 for k, v in metrics.items()},
                     "s": seconds, "launches": launches}
        del s
    return out


def step_rank(mesh, case: StepCase, variants: Sequence[str] = ("none",
                                                               "greg",
                                                               "both")):
    """This rank's run of ``case``'s variants (:func:`run_variants`)."""
    steps, state, inputs = case.build(mesh)
    return run_variants(mesh, steps, state, inputs, variants)


def _protocol_case(world_size: int, batch_per_rank: int = 2) -> StepCase:
    g_cfg, d_cfg = tiny_configs()
    batch = batch_per_rank * world_size
    cfg = ts.TrainConfig(batch_size=batch, simultaneous_main=True,
                         accum_rounds=2)
    rng = np.random.RandomState(2)
    real = np.sin(np.arange(batch, dtype=np.float32)[:, None, None, None]
                  * 0.37 + rng.uniform(0, 1, (batch, 3, 32, 32))
                  ).astype(np.float32)
    z = np.random.RandomState(3).randn(batch, 32).astype(np.float32)
    return StepCase(g_cfg, d_cfg, cfg, real, z, Rng(4))


def _steps(built, start: int, n: int, state=None, variant: str = "both"):
    """Steps ``start`` .. ``start + n - 1`` of ``variant`` from ``built``'s
    (steps, state, inputs), or from ``state``; step i draws from
    ``Rng(4 + i)``."""
    steps, fresh, inputs = built
    state = fresh if state is None else state
    metrics = {}
    for i in range(start, start + n):
        state, metrics = steps[variant](state, *inputs[:4], Rng(4 + i))
    return state, metrics


def modules_rank(mesh) -> list:
    """The top-level modules this rank has imported."""
    import sys

    return sorted({m.split(".")[0] for m in sys.modules})


def replica_check_rank(mesh, leaf: str) -> str:
    """A tree equal on every rank but for ``leaf``, which the last rank
    changes: returns the message that ``check_replica_consistency`` raises
    (every rank raises it), or "" if it raised nothing."""
    tree = {"a": torch.ones(3, device=mesh.device),
            "b": {"c": torch.arange(4.0, device=mesh.device),
                  "d": torch.zeros((), device=mesh.device)}}
    mesh_lib.check_replica_consistency(tree, "tree", mesh)
    if mesh.rank == mesh.world_size - 1:
        t = tree
        for part in leaf.split("/")[:-1]:
            t = t[part]
        t[leaf.split("/")[-1]] += 1e-6
    try:
        mesh_lib.check_replica_consistency(tree, "tree", mesh)
    except AssertionError as e:
        return str(e)
    return ""


def multichip_rank(mesh) -> Dict[str, float]:
    """``__graft_entry__.dryrun_multichip``'s step on this rank: one full
    fused step (Gmain+Dmain, Greg, Dreg, EMA, ``pl_mean``, ``w_avg``) at
    global batch 2 a rank in two rounds; returns its metrics and the
    state's digest."""
    case = _protocol_case(mesh.world_size)
    state, metrics = _steps(case.build(mesh), 0, 1)
    if state.cur_nimg != case.train_cfg.batch_size:
        raise AssertionError(f"cur_nimg {state.cur_nimg}")
    out = {k: float(v) for k, v in metrics.items() if not k.startswith("aux")}
    bad = [k for k, v in out.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite metrics {bad}")
    return {"metrics": out, "digest": state_digest(state)}


def basic_rank(mesh, out_dir: str) -> Dict[str, Any]:
    """Two steps; then a Collector of each rank's per-sample values,
    reduced across ranks, against the global moments; a snapshot that
    only rank 0 writes; the parameters checked equal across ranks."""
    case = _protocol_case(mesh.world_size)
    state, metrics = _steps(case.build(mesh), 0, 2)
    assert state.cur_nimg == 2 * case.train_cfg.batch_size
    metrics = {k: float(v) for k, v in metrics.items()
               if not k.startswith("aux/")}
    for k, v in metrics.items():
        if not np.isfinite(v):
            raise AssertionError(f"non-finite metric {k}")

    n = case.train_cfg.batch_size
    rows = mesh_lib.share_rows(n, mesh.world_size, mesh.rank)
    collector = Collector(mesh)
    collector.report("per_sample", torch.arange(n, dtype=torch.float32)[
        rows] * 0.5)
    moments = collector.as_dict()["per_sample"]
    want = np.arange(n) * 0.5
    if (moments["num"] != n or abs(moments["mean"] - want.mean()) > 1e-9
            or abs(moments["std"] - want.std()) > 1e-9):
        raise AssertionError(f"reduced moments {moments}, want {n} samples "
                             f"of mean {want.mean()} std {want.std()}")

    snap = os.path.join(out_dir, "snapshot.npz")
    if mesh.rank == 0:
        ckpt.save_snapshot(snap, g_params=state.g_params,
                           d_params=state.d_params, g_ema=state.g_ema,
                           config={}, extra={"cur_nimg": np.asarray(
                               state.cur_nimg)})
    mesh.barrier()
    mesh_lib.check_replica_consistency(state.g_params, "G", mesh)
    mesh_lib.check_replica_consistency(state.d_params, "D", mesh)
    return {"rank": mesh.rank, "digest": state_digest(state),
            "metrics": metrics, "wrote_snapshot": mesh.rank == 0,
            "snapshot": os.path.exists(snap)}


def resume_rank(mesh, out_dir: str, phase: str, build: Callable = None,
                variant: str = "both") -> Dict[str, Any]:
    """``phase``: "full" (steps 0-3), "pre" (steps 0-1, then the whole
    train state saved by rank 0) or "resume" (that state restored on every
    rank, steps 2-3), of ``variant`` of ``build(mesh) -> (steps, state,
    inputs)`` (default: the protocol's tiny step).  Returns the rank's
    state digest."""
    if build is None:
        def build(mesh):
            return _protocol_case(mesh.world_size).build(mesh)
    ckpt_dir = os.path.join(out_dir, "state")
    built = build(mesh)
    if phase == "full":
        state, _ = _steps(built, 0, 4, variant=variant)
    elif phase == "pre":
        state, _ = _steps(built, 0, 2, variant=variant)
        ckpt.save_train_state(ckpt_dir, 2, state, mesh=mesh)
    elif phase == "resume":
        state = ckpt.load_train_state(ckpt_dir, 2, built[1])
        state, _ = _steps(built, 2, 2, state, variant=variant)
    else:
        raise ValueError(f"phase {phase!r}: full, pre or resume")
    return {"rank": mesh.rank, "digest": state_digest(state),
            "cur_nimg": state.cur_nimg}


def resume_cycle_rank(mesh, out_dir: str, build: Callable = None,
                      variant: str = "both") -> Dict[str, Any]:
    """The three phases of :func:`resume_rank` in one run of the ranks."""
    return {phase: resume_rank(mesh, out_dir, phase, build, variant)
            for phase in ("full", "pre", "resume")}


def check_resume_cycle(results) -> str:
    """Raises unless every rank's "resume" state is bit-equal to every
    rank's "full" state; returns the digest."""
    digests = {r[p]["digest"] for r in results for p in ("full", "resume")}
    if len(digests) != 1:
        raise AssertionError(f"resume cycle: {len(digests)} different "
                             f"states: {results}")
    return digests.pop()


def mbstd_rank(mesh, x: np.ndarray, weights: np.ndarray, group_size: int,
               num_channels: int = 1) -> Dict[str, np.ndarray]:
    """``minibatch_std`` on this rank's share of the global ``x`` [N, C, H,
    W], with F = sum(out * weights) over the global batch: this rank's rows
    of the output, of dF/dx and of d|dF/dx|^2/dx (the double backward R1
    takes through the layer)."""
    shard = mesh.batch_shard(x.shape[0])
    xs = shard.take(torch.from_numpy(x)).requires_grad_(True)
    out = sg2.minibatch_std(xs, group_size, num_channels, shard)
    f = (out * shard.take(torch.from_numpy(weights))).sum()
    (g,) = torch.autograd.grad(f, xs, create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), xs)
    return {"out": out.detach().numpy(), "grad": g.detach().numpy(),
            "grad2": gg.numpy()}


def augment_rank(mesh, cfg, x: np.ndarray, weights: np.ndarray, p: float,
                 key) -> Dict[str, np.ndarray]:
    """The ADA pipe (``augment_pipe(cfg, ...)``) on this rank's share of
    the global ``x``: its rows of the images and of d sum(images *
    weights) / dx."""
    shard = mesh.batch_shard(x.shape[0])
    xs = shard.take(torch.from_numpy(x)).requires_grad_(True)
    y = aug.augment_pipe(cfg, xs, p, shard.key(key))
    (g,) = torch.autograd.grad(
        (y * shard.take(torch.from_numpy(weights))).sum(), xs)
    return {"images": y.detach().numpy(), "grad": g.numpy()}


def contrast_fitness(img_u8: torch.Tensor) -> torch.Tensor:
    """tests/test_ga.py's fitness: minus the images' mean squared distance
    from mid-gray."""
    return -((img_u8.float() / 255 - 0.5).square().mean())


def ga_rank(mesh, g_cfg: sg2.GeneratorConfig, g_flat: dict,
            ga_cfgs: Sequence, key) -> list:
    """``evolve_directions`` of each of ``ga_cfgs`` from ``key``, with the
    population split over the mesh and :func:`contrast_fitness`; returns
    each run's best direction and history."""
    g_params = ckpt.flat_to_tree(g_flat, mesh.device)
    out = []
    for cfg in ga_cfgs:
        best, history = evolve_directions(key, g_cfg, g_params,
                                          contrast_fitness, cfg, mesh=mesh)
        out.append({"best": best, "history": history})
    return out


def loop_rank(mesh, loop_cfg, train_cfg, g_cfg, d_cfg, data: str,
              augment_cfg=None,
              spatial_shard_min_res: Optional[int] = None) -> Dict[str, Any]:
    """``training_loop`` on this rank over ``data`` (a folder or zip of
    images), with the run directory made per rank (``run_dir/rankN``) so
    that the files each rank wrote can be told apart; returns the final
    state's digest and the files written."""
    run_dir = os.path.join(loop_cfg.run_dir, f"rank{mesh.rank}")
    state = training_loop(dataclasses.replace(loop_cfg, run_dir=run_dir),
                          train_cfg, g_cfg, d_cfg, ImageFolderDataset(data),
                          augment_cfg=augment_cfg,
                          spatial_shard_min_res=spatial_shard_min_res,
                          mesh=mesh)
    files = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []
    return {"digest": state_digest(state), "files": files,
            "cur_nimg": state.cur_nimg}


@dataclasses.dataclass
class SpatialCase:
    """The checks of :func:`spatial_rank`, each optional: ``synthesis``,
    (g_cfg, flat G weights, ws, [(label, min_res, None or (offsets spec,
    offsets tree of numpy))]); ``d``, (d_cfg, flat D weights, real images);
    ``step``, a :class:`StepCase` with ``spatial_min_res``, run in the
    ``variants`` named; ``probes``: the exchanges' adjoints and
    gradchecks."""
    synthesis: Optional[tuple] = None
    d: Optional[tuple] = None
    step: Optional[StepCase] = None
    probes: bool = False
    variants: tuple = tuple(v for v, _, _ in VARIANTS)


def spatial_synthesis(mesh, g_cfg, g_flat, ws, min_res, offsets=None):
    """``spatial_synthesis_fn`` on this rank, with the hooks of an offsets
    (spec, tree) as its base hooks: (the image gathered whole, the shape of
    the rank's block)."""
    params = ckpt.flat_to_tree(g_flat, mesh.device)
    base = None
    if offsets is not None:
        spec, tree = offsets
        base = offs_lib.make_hooks(
            offs_lib.OffsetsSpec.from_string(spec),
            {k: {kk: torch.from_numpy(vv).to(mesh.device)
                 for kk, vv in v.items()} for k, v in tree.items()})
    fn = spatial_lib.spatial_synthesis_fn(g_cfg, mesh, min_res=min_res,
                                          base_hooks=base)
    rows = fn(params, torch.from_numpy(ws).to(mesh.device))
    return spatial_lib.gather_rows(rows, mesh, g_cfg.img_resolution).cpu(
    ).numpy(), tuple(rows.shape)


def spatial_d(mesh, d_cfg, d_flat, real) -> Dict[str, np.ndarray]:
    """D under ``d_spatial_constraint`` on this rank: the logits, the R1
    penalty's per-sample values and its gradient with respect to every D
    leaf (through the exchanges twice)."""
    params = ckpt.flat_to_tree(d_flat, mesh.device)
    leaves = ckpt.tree_to_flat_tensors(params)
    for t in leaves.values():
        t.requires_grad_(True)
    constraint = spatial_lib.d_spatial_constraint(mesh)
    img = torch.from_numpy(real).to(mesh.device).requires_grad_(True)
    logits = sg2.discriminator_apply(d_cfg, params, img,
                                     spatial_constraint=constraint)
    (g,) = torch.autograd.grad(logits.sum(), img, create_graph=True)
    r1 = g.square().sum(dim=(1, 2, 3))
    grads = torch.autograd.grad(r1.sum(), list(leaves.values()),
                                allow_unused=True)
    return {"logits": logits.detach().cpu().numpy(),
            "r1": r1.detach().cpu().numpy(),
            "grads": {k: (torch.zeros_like(t) if g is None else g).cpu()
                      .numpy() for (k, t), g in zip(leaves.items(), grads)}}


def _probe_fns(layout, h: int):
    """Three maps of a [1, 2, h, 3] input (and a [2, 2, 3, 3] weight), each
    whole on every rank, through one of the pairs: "halo" (rows, a halo of
    one, a 3x3 conv without H padding, tanh, gather), "enter" (the weight
    entered into the rows' product), "gather" (rows, tanh, gather,
    squared)."""

    def halo(x, w):
        win = layout.window(layout.rows(x, h), h, 1)[0]
        (w,) = layout.enter(w)
        y = torch.nn.functional.conv2d(win, w, padding=(0, 1))
        return layout.gather(torch.tanh(y), h)

    def enter(x, w):
        (w,) = layout.enter(w)
        y = layout.rows(x, h) * w[:, :, :1, :].sum(dim=2, keepdim=True)
        return layout.gather(torch.tanh(y), h)

    def gather(x, w):
        return layout.gather(torch.tanh(layout.rows(x, h)), h).square() * w[
            0, 0, 0, 0]

    return {"halo": halo, "enter": enter, "gather": gather}


def _adjoint_gap(mesh, fn, x, y, x_whole: bool, y_whole: bool) -> float:
    """|<fn(x), y> - <x, fn^T(y)>| relative, fn^T the autograd backward.
    An inner product of rank-local tensors is summed over the ranks, one of
    tensors whole on every rank (``x_whole`` / ``y_whole``) taken once."""
    x = x.clone().requires_grad_(True)
    out = fn(x)
    (xt,) = torch.autograd.grad(out, x, y)
    n = mesh.world_size
    dots = torch.stack([(out.detach() * y).sum() / (n if y_whole else 1),
                        (x.detach() * xt).sum() / (n if x_whole else 1)])
    mesh.all_reduce_(dots)
    return float((dots[0] - dots[1]).abs() / dots.abs().max())


def spatial_probes(mesh) -> Dict[str, Any]:
    """Each exchange pair (:mod:`parallel.spatial`) on maps whose blocks
    differ in size: the gap between <A x, y> and <x, A^T y> (float64,
    summed over the ranks) for A the window exchange (rows in, a window
    out: "halo" two rows each side, "up" the rows under an up=2 op's
    blocks, "down" those under a stride-2 op's), ``enter`` and the row
    gather, and ``gradcheck`` / ``gradgradcheck`` of a map of whole tensors
    through the halo exchange, ``enter`` and the gather."""
    layout = spatial_lib.RowLayout(mesh)
    h = 4 * mesh.world_size + 1
    gen = torch.Generator().manual_seed(0)
    local = torch.Generator().manual_seed(100 + mesh.rank)
    f64 = dict(dtype=torch.float64)

    def rows(h):
        s, e = layout.block(h)
        return e - s

    def window_gap(h, k, out_h):
        (a, b), _ = spatial_lib.op_windows(h, out_h, k, layout.world_size)[
            mesh.rank]
        return _adjoint_gap(
            mesh, lambda v: layout.window(v, h, k, out_h)[0],
            torch.randn((1, 2, rows(h), 3), generator=local, **f64),
            torch.randn((1, 2, b - a, 3), generator=local, **f64),
            False, False)

    adjoint = {
        "halo": window_gap(h, 2, h),
        "up": window_gap(h, 1, 2 * h),
        "down": window_gap(h + 1, 2, (h + 1) // 2),
        "enter": _adjoint_gap(
            mesh, lambda v: layout.enter(v)[0] * 1.0,
            torch.randn((2, 3), generator=gen, **f64),
            torch.randn((2, 3), generator=local, **f64), True, False),
        "gather": _adjoint_gap(
            mesh, lambda v: layout.gather(v, h),
            torch.randn((1, 2, rows(h), 3), generator=local, **f64),
            torch.randn((1, 2, h, 3), generator=gen, **f64), False, True),
    }
    x = torch.randn((1, 2, h, 3), generator=gen, **f64).requires_grad_(True)
    w = torch.randn((2, 2, 3, 3), generator=gen, **f64).requires_grad_(True)
    checks = {}
    # gradgradcheck draws its output gradients from the global generator:
    # the same on every rank, as the outputs are whole on every rank.
    torch.manual_seed(0)
    for name, fn in _probe_fns(layout, h).items():
        checks[name] = (
            torch.autograd.gradcheck(fn, (x, w), raise_exception=False),
            torch.autograd.gradgradcheck(fn, (x, w), raise_exception=False))
    return {"adjoint": adjoint, "gradcheck": checks}


def spatial_rank(mesh, case: SpatialCase) -> Dict[str, Any]:
    """This rank's run of ``case``'s checks, with the collectives each
    issued (``parallel.spatial.STATS``)."""
    out: Dict[str, Any] = {}
    if case.probes:
        out["probes"] = spatial_probes(mesh)
    if case.synthesis is not None:
        g_cfg, g_flat, ws, synth_runs = case.synthesis
        out["synthesis"] = {
            label: spatial_synthesis(mesh, g_cfg, g_flat, ws, min_res,
                                     offsets)
            for label, min_res, offsets in synth_runs}
    if case.d is not None:
        out["d"] = spatial_d(mesh, *case.d)
    if case.step is not None:
        spatial_lib.reset_stats()
        out["step"] = run_variants(mesh, *case.step.build(mesh),
                                   case.variants)
        out["stats"] = dict(spatial_lib.STATS)
    return out


def protocols_rank(mesh, out_dir: str) -> Dict[str, Any]:
    """The ``basic`` protocol, the resume cycle and the replica check (a
    leaf changed on the last rank) in one run of the ranks."""
    return {"basic": basic_rank(mesh, out_dir),
            "resume": resume_cycle_rank(mesh, out_dir),
            "replica": replica_check_rank(mesh, "b/c")}


def check_protocols(results) -> None:
    """Raises unless the ranks of :func:`protocols_rank` agree bit for bit,
    only rank 0 wrote the snapshot and the resume cycle is bit-equal."""
    basic = [r["basic"] for r in results]
    if len({r["digest"] for r in basic}) != 1:
        raise AssertionError(f"ranks disagree: {basic}")
    if [r["wrote_snapshot"] for r in basic] != [True] + [False] * (
            len(basic) - 1) or not all(r["snapshot"] for r in basic):
        raise AssertionError(f"snapshot gating: {basic}")
    check_resume_cycle([r["resume"] for r in results])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda: rank r on cuda:r (NCCL); cpu: CPU ranks "
                         "(gloo); cuda:0: every rank on that card (needs "
                         "--backend gloo)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    devices = None if args.device == "cuda" else args.device
    with tempfile.TemporaryDirectory() as out_dir:
        results = mesh_lib.spawn(protocols_rank, args.ranks, args.backend,
                                 devices, args.timeout, args=(out_dir,),
                                 limit=args.timeout)
    check_protocols(results)
    print("dryrun ok")
    return results


if __name__ == "__main__":
    main()
