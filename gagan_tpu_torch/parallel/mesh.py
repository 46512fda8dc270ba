"""Data parallelism over ``torch.distributed`` ranks (port of
gagan_tpu/parallel/mesh.py).

The JAX module jits one SPMD program over a device mesh and lets XLA insert
the gradient all-reduce where a loss mean crosses the batch axis.  The port
runs one process per rank, as the reference deploys (one process per GPU
over NCCL, ``DissimilarDomains/train.py:472-500``), and makes the
collectives explicit:

* every rank holds the whole state, replicated; each reads only its share
  of the global batch (:func:`share_rows`: its contiguous block of each
  accumulation round's chunk, which is where JAX's ``_chunk`` then
  ``shard_batch`` put the rows);
* every random draw is made from the same key on every rank at the global
  batch's shape, and each rank keeps its rows (:class:`ShardedRng`);
* a phase's losses are local means; its gradients and logged means go
  through one ``all_reduce`` (SUM) and are divided by the world size, which
  is the global mean because every rank holds as many rows;
* the statistics that read several samples at once (the minibatch stddev
  of D's epilogue, the path-length mean) see the global batch through
  :class:`BatchShard`.

Every collective is built on ``all_reduce`` and ``broadcast`` only: gloo
has no other on CUDA tensors.  A gather is an ``all_reduce`` of a
zero-filled buffer into which each rank writes its own rows.  NCCL is the
backend when each rank has a card of its own; gloo runs on the CPU, and on
a card only when the caller asks for it (two ranks sharing one card, which
NCCL refuses).

With a world of one and no process group every collective is the identity
and the step is the one-process step.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import hashlib
import os
import pickle
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

DEFAULT_TIMEOUT = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D data-parallel world: its rank, the world
    size, the device it computes on, the backend and the process group
    (None for a world of one run without a group)."""
    world_size: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None

    @property
    def sharded(self) -> bool:
        """True when the collectives run (a process group exists)."""
        return self.group is not None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        if self.sharded:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.sharded:
            dist.broadcast(t, src=src, group=self.group)
        return t

    def barrier(self) -> None:
        """Wait for every rank (an all_reduce, which both backends run on
        the mesh's device)."""
        self.all_reduce_(torch.zeros(1, device=self.device))

    def gather(self, x: torch.Tensor, rows, n: int) -> torch.Tensor:
        """The [n, ...] tensor whose rows ``rows`` are this rank's ``x``
        and whose other rows are the other ranks' (no autograd)."""
        buf = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        buf[torch.as_tensor(rows, device=x.device)] = x
        return self.all_reduce_(buf)

    def batch_shard(self, n: int, rounds: int = 1) -> "BatchShard":
        """The shard of a global batch of ``n`` that this rank holds when
        the batch is laid out in ``rounds`` chunks (:func:`share_rows`)."""
        return BatchShard(self, share_rows(n, self.world_size, self.rank,
                                           rounds), n)


def share_rows(n: int, world_size: int, rank: int,
               rounds: int = 1) -> List[int]:
    """The positions, in a global batch of ``n``, that ``rank`` holds: its
    contiguous block of each of ``rounds`` equal chunks.  JAX's step cuts
    the global batch into accumulation rounds and each round's chunk is
    split over the mesh, so this is the rank's share of every round; the
    loaders, :func:`shard_batch` and the train step all take it from here."""
    if n % (rounds * world_size):
        raise ValueError(
            f"a batch of {n} does not split into {rounds} round(s) over "
            f"{world_size} rank(s): it must be a multiple of "
            f"{rounds * world_size}")
    chunk = n // rounds
    block = chunk // world_size
    return [r * chunk + rank * block + i
            for r in range(rounds) for i in range(block)]


class BatchShard:
    """A rank's rows of one global batch: gathers across ranks with
    autograd, the rank's rows of a global tensor, global means, and the
    draws of :class:`ShardedRng`."""

    def __init__(self, mesh: Mesh, rows: Sequence[int], n: int):
        self.mesh = mesh
        self.rows = list(rows)
        self.n = n
        self._index = {}

    def index(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._index:
            self._index[device] = torch.as_tensor(self.rows, device=device)
        return self._index[device]

    def take(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of the global tensor ``t`` (None passes)."""
        return None if t is None else t[self.index(t.device)]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global [n, ...] tensor of every rank's ``x``.  Its backward
        sums the gradient over the ranks and keeps this rank's rows, and
        is itself differentiable (R1 differentiates through it twice)."""
        return _GatherRows.apply(x, self)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The global mean of the per-sample ``x`` (detached)."""
        m = x.detach().mean().clone()
        return self.mesh.all_reduce_(m) / self.mesh.world_size

    def key(self, key) -> "ShardedRng":
        return ShardedRng(key, self)

    def _reduce_rows(self, g: torch.Tensor) -> torch.Tensor:
        return self.take(self.mesh.all_reduce_(g.clone()))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard.mesh.gather(x, shard.index(x.device), shard.n)

    @staticmethod
    def backward(ctx, g):
        return _ReduceRows.apply(g, ctx.shard), None


class _ReduceRows(torch.autograd.Function):
    """The adjoint of :class:`_GatherRows`: sum over the ranks, keep this
    rank's rows; its own adjoint is the gather."""

    @staticmethod
    def forward(ctx, g, shard):
        ctx.shard = shard
        return shard._reduce_rows(g)

    @staticmethod
    def backward(ctx, g):
        return _GatherRows.apply(g, ctx.shard), None


class ShardedRng:
    """A key whose draws are made at the global batch's shape and cut to
    the shard's rows, so that every rank sees the one-process run's numbers
    for its samples.  A draw of shape () is the same on every rank; any
    other draw must lead with the shard's local batch.  ``split`` and
    ``fold_in`` keep the wrapping, so the whole key tree below a phase's
    round key is sharded."""

    def __init__(self, inner, shard: BatchShard):
        self.inner = inner
        self.shard = shard

    def split(self, n: int):
        return [ShardedRng(k, self.shard) for k in self.inner.split(n)]

    def fold_in(self, data: int) -> "ShardedRng":
        return ShardedRng(self.inner.fold_in(data), self.shard)

    def _draw(self, fn, shape, *args, device):
        shape = tuple(shape)
        if not shape:
            return fn(shape, *args, device=device)
        local = len(self.shard.rows)
        if shape[0] != local:
            raise ValueError(
                f"a sharded draw of shape {shape} does not lead with the "
                f"rank's batch of {local}")
        full = fn((self.shard.n,) + shape[1:], *args, device=device)
        return self.shard.take(full)

    def normal(self, shape, device="cpu"):
        return self._draw(self.inner.normal, shape, device=device)

    def uniform(self, shape, device="cpu"):
        return self._draw(self.inner.uniform, shape, device=device)

    def randint(self, shape, low, high, device="cpu"):
        return self._draw(self.inner.randint, shape, low, high, device=device)


# ----------------------------------------------------------------------------
# Making the mesh


def rank_devices(world_size: int, devices=None) -> List[torch.device]:
    """Each rank's device: ``devices`` as given (one per rank, or one for
    all), else cuda:0..world_size-1.  Refuses more ranks than cards."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices='cpu' to run the ranks on the "
                "CPU over gloo")
        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"{world_size} ranks asked for, but {torch.cuda.device_count()}"
                f" CUDA device(s) are visible")
        return [torch.device("cuda", i) for i in range(world_size)]
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * world_size
    devices = [torch.device(d) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    return devices


def resolve_backend(backend: Optional[str],
                    devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, gloo on the CPU; gloo on
    a card only when asked for.  NCCL is refused for two ranks on one card
    or for CPU ranks, before any process group is made."""
    on_cuda = [d.type == "cuda" for d in devices]
    if backend is None:
        backend = "nccl" if all(on_cuda) else "gloo"
    if backend == "nccl":
        if not all(on_cuda):
            raise ValueError("NCCL runs on CUDA devices only; use "
                             "backend='gloo' for CPU ranks")
        seen = [str(d) for d in devices]
        dup = sorted({d for d in seen if seen.count(d) > 1})
        if dup:
            raise ValueError(
                f"NCCL cannot run two ranks on one card ({', '.join(dup)} "
                f"is given to several ranks); ask for backend='gloo' to "
                f"share a card")
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    return backend


def _init_group(backend: str, rank: int, world_size: int, device,
                init_method: str, timeout: float) -> Mesh:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    return Mesh(world_size, rank, device, backend, dist.group.WORLD)


def create_mesh(n_devices: Optional[int] = None, device=None,
                backend: Optional[str] = None,
                timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """This process's mesh.

    * Inside an initialised process group (a rank started by :func:`spawn`,
      or one that made its group itself): that group.
    * Started by ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set): joins its
      group over ``env://``, on cuda:``LOCAL_RANK`` unless ``device`` says
      otherwise.
    * Otherwise a world of one on ``device`` (default cuda) with no group.

    ``n_devices``, when given, must equal the world size."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        be = dist.get_backend()
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if be == "nccl" else torch.device("cpu"))
        mesh = Mesh(world, rank, torch.device(device), be, dist.group.WORLD)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if device is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             rank)))
        device = torch.device(device)
        be = resolve_backend(backend, [device])
        mesh = _init_group(be, rank, world, device, "env://", timeout)
    else:
        device = resolve_device(device or "cuda")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = Mesh(1, 0, device)
    if n_devices is not None and n_devices != mesh.world_size:
        raise ValueError(
            f"n_devices={n_devices}, but this process's world has "
            f"{mesh.world_size} rank(s): start {n_devices} ranks with "
            f"parallel.mesh.spawn, cli/train.py --gpus {n_devices} or "
            f"torchrun --nproc-per-node {n_devices}")
    return mesh


# ----------------------------------------------------------------------------
# The JAX module's functions


def shard_batch(mesh: Mesh, batch, rounds: int = 1):
    """This rank's share (:func:`share_rows`) of a global host batch: a
    tensor, an array or a tuple / list / dict of them (None passes), moved
    to the mesh's device."""
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, rounds) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v, rounds) for v in batch)
    x = torch.as_tensor(batch)
    rows = share_rows(x.shape[0], mesh.world_size, mesh.rank, rounds)
    return x[torch.as_tensor(rows)].to(mesh.device)


def _tensor_leaves(tree) -> dict:
    from ..utils.checkpoint import train_state_leaves

    return {k: v for k, v in train_state_leaves(tree).items()
            if isinstance(v, torch.Tensor)}


def place_state(mesh: Mesh, state):
    """Make ``state`` replicated: every tensor leaf (parameters, EMA, Adam
    moments, ``pl_mean``, ``ada_p``) takes rank 0's values, in place.  The
    leaves must already be on the mesh's device."""
    for k, t in _tensor_leaves(state).items():
        if t.device != mesh.device:
            raise ValueError(f"place_state: {k} is on {t.device}, the mesh "
                             f"on {mesh.device}")
        mesh.broadcast_(t.data)
    return state


def shard_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """The step ``step(state, real_img, real_c, z, gen_c, key)`` of
    ``train_step.make_fused_step`` run as this rank's part of the mesh:
    ``real_img`` / ``real_c`` are the rank's share (:func:`shard_batch`
    with ``train_step.data_rounds(cfg)`` rounds); ``z``, ``gen_c`` and the
    key are the global ones, equal on every rank.  Each phase all-reduces
    its gradients before Adam; the state stays replicated.  A mesh without
    a process group leaves ``step_fn`` as it is: the one-process step."""
    if not mesh.sharded:
        return step_fn
    return functools.partial(step_fn, mesh=mesh)


def _digest(t: torch.Tensor) -> np.ndarray:
    raw = t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy()
    return np.frombuffer(hashlib.sha1(raw.tobytes()).digest(),
                         dtype=np.uint8).astype(np.float64)


def check_replica_consistency(tree: Any, name: str = "params",
                              mesh: Optional[Mesh] = None) -> None:
    """Raise AssertionError naming the first leaf of ``tree`` (a parameter
    tree or a train state) whose bytes differ between rank 0 and another
    rank, the counterpart of the reference's pre-snapshot
    ``misc.check_ddp_consistency``.  A no-op in a world of one."""
    if mesh is None:
        if not (dist.is_available() and dist.is_initialized()):
            return
        mesh = create_mesh()
    if not mesh.sharded or mesh.world_size == 1:
        return
    leaves = _tensor_leaves(tree)
    names = sorted(leaves)
    mine = torch.as_tensor(np.stack([_digest(leaves[k]) for k in names]),
                           device=mesh.device)
    every = mesh.gather(mine[None], [mesh.rank], mesh.world_size)
    for r in range(1, mesh.world_size):
        bad = (every[r] != every[0]).any(dim=1).nonzero()
        if len(bad):
            raise AssertionError(
                f"replica mismatch in {name}.{names[int(bad[0])]} between "
                f"ranks 0 and {r}")


# ----------------------------------------------------------------------------
# Starting ranks


def _rank_main(rank, world_size, backend, device, init_method, timeout,
               threads, results, fn, args):
    """One spawned rank: its group made, then ``fn(mesh, *args)``; the
    result or the traceback goes to ``results``."""
    torch.set_num_threads(threads)
    try:
        mesh = _init_group(backend, rank, world_size, device, init_method,
                           timeout)
        try:
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        # Pickled here by value: the queue would share tensors through
        # file descriptors that die with this process.
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world_size: int, backend: Optional[str] = None,
          devices=None, timeout: float = DEFAULT_TIMEOUT,
          args: tuple = (), limit: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args)`` in ``world_size`` new processes, one rank
    each (the ``spawn`` start method: CUDA cannot be forked), and return
    their results in rank order.  ``fn`` and ``args`` must pickle (``fn`` a
    module-level function).  ``devices``: one per rank or one for all
    (default cuda:0..world_size-1); ``backend`` as :func:`resolve_backend`
    picks it.  The group meets through a file store in a temporary
    directory.  ``timeout`` (seconds) bounds each collective, so a rank
    left waiting on a lost one fails; ``limit`` (seconds, default none)
    bounds the whole run.  When a rank fails, exits early or outlives the
    limit, the others are killed and the error names it, with its
    traceback where it raised one."""
    devices = rank_devices(world_size, devices)
    backend = resolve_backend(backend, devices)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    # The ranks share the parent's CPU threads.
    threads = max(1, torch.get_num_threads() // world_size)
    deadline = None if limit is None else time.monotonic() + limit
    with tempfile.TemporaryDirectory(prefix="gagan_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, world_size, backend, str(devices[r]), init, timeout,
                  threads, results, fn, args))
            for r in range(world_size)]
        for p in procs:
            p.start()
        out: dict = {}
        dead: set = set()
        try:
            while len(out) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_lib.Empty:
                    _check_alive(procs, out, dead, deadline, limit)
                    continue
                if not ok:
                    raise RuntimeError(
                        f"rank {rank} of {world_size} failed:\n{value}")
                out[rank] = pickle.loads(value)
            for r, p in enumerate(procs):
                p.join(timeout=timeout)
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} of {world_size} exited "
                                       f"with code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
            results.close()
            results.join_thread()
    return [out[r] for r in range(world_size)]


def _check_alive(procs, done, dead, deadline, limit) -> None:
    """Raise for a rank that exited without a result (seen dead on two
    polls: a failing rank's traceback may still be on its way) or for the
    ranks still running past the limit."""
    for r, p in enumerate(procs):
        if r not in done and not p.is_alive():
            if r in dead:
                raise RuntimeError(f"rank {r} of {len(procs)} exited with "
                                   f"code {p.exitcode} before it returned")
            dead.add(r)
    if deadline is not None and time.monotonic() > deadline:
        left = sorted(set(range(len(procs))) - set(done))
        raise RuntimeError(f"rank(s) {left} of {len(procs)} still running "
                           f"after {limit:.0f} s")
