"""Spatial (height) sharding of high-resolution synthesis and of the
discriminator (port of gagan_tpu/parallel/spatial.py).

At 1024^2 the activation maps, not the batch, fill a card's memory.  The
JAX module shards the H axis of the large maps over its mesh with
numeric-identity ``with_sharding_constraint`` hooks and lets XLA insert the
halo exchanges.  Nothing inserts them here: every rank of a
:class:`~gagan_tpu_torch.parallel.mesh.Mesh` (one process each) holds the
whole global batch, replicated state, and of each sharded map only its
rows, and the layers exchange their edge rows themselves.

Layout (JAX's ``P(None, None, axis, None)``): rank ``r`` of ``n`` holds rows
``[r*H/n, (r+1)*H/n)`` of a sharded ``[N, C, H, W]`` map, every sample.
Mapping, styles, the blocks below the sharded resolutions, D's epilogue
and the losses run whole on every rank.  A map that ``n`` does not split
into equal blocks, or whose block would start on an odd row in front of a
stride-2 op, is refused with a ``ValueError`` (XLA pads uneven shards; the
port does not).

Each sharded layer takes a window of its input: its own rows and a halo of
``k`` rows from each neighbour (zero rows at the image's edges), runs the
port's composed op on the window with its usual padding, and keeps the
rows that belong to it (:meth:`RowLayout.window`, :meth:`RowLayout.crop`).

The collectives are ``torch.autograd.Function`` pairs whose backward is the
other of the pair, so that R1 and path-length regularisation differentiate
through them twice:

* the halo exchange and its adjoint, which sends the halo rows' gradients
  back to their owners and adds them there;
* ``enter`` (identity; backward: an all_reduce of the gradient) where a
  replicated tensor (a style, a weight, a bias, a noise strength, an image
  or map that is whole on every rank) enters the row-sharded computation,
  whose gradient on a rank is its rows' part only;
* the all_reduce (backward: identity), which with a zero-filled buffer
  makes the row gather (:meth:`RowLayout.gather`); the row slice of a
  replicated tensor is ``enter`` then a local slice, its adjoint.

So the gradient of every replicated tensor leaves the backward whole and
bit-equal on every rank: the train step adds no all_reduce of its own.
Every collective is an ``all_reduce`` (the mesh's ``all_reduce_``; gloo
has no other on CUDA tensors).  :data:`STATS` counts them and the bytes a
rank hands to them.

With a world of one, or no process group, spatial sharding is the
identity: the hooks keep their keys (a "post" slot keeps a layer off the
fused level and the packed tail unpacked, as in JAX) but no layer runs on
rows.
"""

from __future__ import annotations

import collections
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..models import stylegan2 as sg2
from ..models.stylegan2 import LayerHooks

# Collectives issued by this module since the last reset_stats(): "exchanges"
# (all of them), "bytes" (the bytes a rank handed to them), and counts by
# kind: "halo" (halo exchanges and their adjoints), "enter" (the gradient
# all_reduces of enter), "gather" (row gathers and the all_reduces that are
# enter's adjoints).
STATS: "collections.Counter[str]" = collections.Counter()


def reset_stats() -> None:
    STATS.clear()


def _all_reduce(mesh, t: torch.Tensor, kind: str) -> torch.Tensor:
    STATS["exchanges"] += 1
    STATS[kind] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    return mesh.all_reduce_(t)


# ----------------------------------------------------------------------------
# The autograd pairs


class _Enter(torch.autograd.Function):
    """Identity; the backward sums the tensors' gradients over the ranks,
    in one all_reduce of a flat bucket (fp32, or wider)."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(_SumRanks.apply(ctx.mesh, *gs))


class _SumRanks(torch.autograd.Function):
    """The tensors summed over the ranks (one all_reduce of a flat bucket
    in fp32, or the widest of their dtypes); its adjoint is
    :class:`_Enter`."""

    @staticmethod
    def forward(ctx, mesh, *gs):
        ctx.mesh = mesh
        dtype = functools.reduce(torch.promote_types, [g.dtype for g in gs],
                                 torch.float32)
        bucket = torch.cat([g.detach().reshape(-1).to(dtype) for g in gs])
        _all_reduce(mesh, bucket, "enter")
        out, offset = [], 0
        for g in gs:
            out.append(bucket[offset:offset + g.numel()].view(g.shape)
                       .to(g.dtype))
            offset += g.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(_Enter.apply(ctx.mesh, *gs))


class _AllReduce(torch.autograd.Function):
    """A tensor summed over the ranks; its backward is the identity (the
    gradient of a replicated tensor is whole on every rank), whose own
    backward is this again."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(mesh, x.detach().clone(), "gather")

    @staticmethod
    def backward(ctx, g):
        return _Identity.apply(g, ctx.mesh), None


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, mesh):
        ctx.mesh = mesh
        return g.view_as(g)

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.mesh), None


class _Halo(torch.autograd.Function):
    """This rank's rows with ``k`` rows of the rank above in front and ``k``
    of the rank below behind (zero rows at the image's edges); its adjoint
    is :class:`_HaloReturn`."""

    @staticmethod
    def forward(ctx, x, layout, k):
        ctx.args = (layout, k)
        return layout._halo(x, k)

    @staticmethod
    def backward(ctx, g):
        return _HaloReturn.apply(g, *ctx.args), None, None


class _HaloReturn(torch.autograd.Function):
    """The adjoint of :class:`_Halo`: a window's halo rows sent back to the
    ranks that own them and added into those rows."""

    @staticmethod
    def forward(ctx, g, layout, k):
        ctx.args = (layout, k)
        return layout._halo_return(g, k)

    @staticmethod
    def backward(ctx, g):
        return _Halo.apply(g, *ctx.args), None, None


# ----------------------------------------------------------------------------
# The row layout


class RowLayout:
    """The row blocks of the maps sharded over ``mesh``'s ranks, and the
    operations of a layer on them.  A map of ``h`` rows is this rank's
    block when it holds ``h / world_size`` rows, and whole (replicated)
    when it holds ``h``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.world_size = mesh.world_size if mesh.sharded else 1
        self.rank = mesh.rank if mesh.sharded else 0

    def block(self, h: int, stride2: bool = False):
        """(first row, end row) of this rank's block of a map of ``h``
        rows.  Refuses a map that does not split into equal blocks, and
        with ``stride2`` a block that would start on an odd row."""
        n = self.world_size
        if h % n:
            raise ValueError(
                f"spatial sharding over {n} ranks: a {h}-row map does not "
                f"split into {n} equal row blocks")
        rows = h // n
        if stride2 and rows % 2:
            raise ValueError(
                f"spatial sharding over {n} ranks: the {h}-row map's blocks "
                f"of {rows} row(s) would start on an odd row in front of a "
                f"stride-2 op")
        return self.rank * rows, (self.rank + 1) * rows

    def is_rows(self, x: torch.Tensor, h: int) -> bool:
        """Whether ``x`` (of a map of ``h`` rows) is this rank's block
        (False: the whole map)."""
        if x.shape[-2] == h:
            return False
        if x.shape[-2] * self.world_size != h:
            raise ValueError(f"a tensor of {x.shape[-2]} rows is neither a "
                             f"{h}-row map nor one of its "
                             f"{self.world_size} row blocks")
        return True

    def enter(self, *ts):
        """The tensors, each whole on every rank, as they enter the row
        computation: their gradients are summed over the ranks in the
        backward.  None and tensors that take no gradient pass."""
        idx = [i for i, t in enumerate(ts)
               if t is not None and t.requires_grad]
        if not idx or not torch.is_grad_enabled():
            return ts
        entered = _Enter.apply(self.mesh, *[ts[i] for i in idx])
        out = list(ts)
        for i, t in zip(idx, entered):
            out[i] = t
        return tuple(out)

    def enter_tree(self, tree):
        """:meth:`enter` of every tensor of a parameter tree (a dict of
        dicts), in one bucket."""
        flat = []

        def walk(t):
            for v in t.values():
                if isinstance(v, dict):
                    walk(v)
                else:
                    flat.append(v)
        walk(tree)
        it = iter(self.enter(*flat))

        def build(t):
            return {k: build(v) if isinstance(v, dict) else next(it)
                    for k, v in t.items()}
        return build(tree)

    def window(self, x: torch.Tensor, h: int, k: int,
               stride2: bool = False) -> torch.Tensor:
        """Rows ``[s - k, e + k)`` of the ``h``-row map, this rank's block
        being ``[s, e)``, zero outside the map: from the rank's block by a
        halo exchange, or sliced out of the whole map."""
        s, e = self.block(h, stride2)
        if self.is_rows(x, h):
            return _Halo.apply(x, self, k) if k else x
        (x,) = self.enter(x)
        lo, hi = s - k, e + k
        piece = x[..., max(lo, 0):min(hi, h), :]
        return F.pad(piece, (0, 0, max(-lo, 0), max(hi - h, 0)))

    def rows(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """This rank's block of a map whole on every rank (or the block
        itself)."""
        return self.window(x, h, 0)

    def crop(self, y: torch.Tensor, offset: int, h: int) -> torch.Tensor:
        """Rows ``[offset, offset + h / world_size)`` of an op's output on
        a window: the rank's block of the ``h``-row output map."""
        return y[..., offset:offset + h // self.world_size, :]

    def gather(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """The whole ``h``-row map from every rank's block (the map itself
        when it is whole already).  Its backward keeps the rank's rows of
        the gradient."""
        if not self.is_rows(x, h):
            return x
        s, e = self.block(h)
        return _AllReduce.apply(F.pad(x, (0, 0, s, h - e)), self.mesh)

    def _halo(self, x, k):
        """Each rank hands its last k rows (the halo above of the rank
        below) and its first k (the halo below of the rank above) to one
        all_reduce of a zero-filled [world_size, ...] buffer."""
        n, r = self.world_size, self.rank
        rows = x.shape[-2]
        if rows < k:
            raise ValueError(f"a halo of {k} rows is more than a block of "
                             f"{rows}")
        x = x.detach()
        buf = x.new_zeros((n,) + tuple(x.shape[:-2]) + (2 * k, x.shape[-1]))
        buf[r] = torch.cat([x[..., rows - k:, :], x[..., :k, :]], -2)
        _all_reduce(self.mesh, buf, "halo")
        edge = torch.zeros_like(buf[r][..., :k, :])
        above = buf[r - 1][..., :k, :] if r > 0 else edge
        below = buf[r + 1][..., k:, :] if r < n - 1 else edge
        return torch.cat([above, x, below], -2)

    def _halo_return(self, g, k):
        n, r = self.world_size, self.rank
        g = g.detach()
        rows = g.shape[-2] - 2 * k
        buf = g.new_zeros((n,) + tuple(g.shape[:-2]) + (2 * k, g.shape[-1]))
        buf[r] = torch.cat([g[..., :k, :], g[..., k + rows:, :]], -2)
        _all_reduce(self.mesh, buf, "halo")
        dx = g[..., k:k + rows, :].clone()
        if r < n - 1:
            dx[..., rows - k:, :] += buf[r + 1][..., :k, :]
        if r > 0:
            dx[..., :k, :] += buf[r - 1][..., k:, :]
        return dx


class RowShard:
    """The "post" slot of a row-sharded synthesis layer: numerically the
    identity, carrying the layout (``row_layout``) that
    ``models/stylegan2.py`` runs the layer on."""

    def __init__(self, layout: RowLayout):
        self.row_layout = layout

    def __call__(self, x):
        return x


class _Chain:
    """Two hooks of one slot composed, ``then(first(v))``; a layout either
    carries is kept."""

    def __init__(self, first, then):
        self.first, self.then = first, then
        self.row_layout = (getattr(first, "row_layout", None)
                           or getattr(then, "row_layout", None))

    def __call__(self, v):
        return self.then(self.first(v))


class DSpatialConstraint:
    """What :func:`d_spatial_constraint` returns: numerically the identity,
    carrying the layout and the replication floor that
    ``discriminator_apply`` reads."""

    def __init__(self, layout: RowLayout, min_rows: int):
        self.row_layout = layout
        self.min_rows = min_rows

    def sharded(self, h: int) -> bool:
        """Whether a block input of ``h`` rows runs on row blocks."""
        n = self.row_layout.world_size
        return n > 1 and h >= self.min_rows * n

    def __call__(self, x):
        return x


# ----------------------------------------------------------------------------
# The JAX module's functions


def spatial_sharding_hooks(cfg: sg2.SynthesisConfig, mesh,
                           axis: str = "data", min_res: int = 256,
                           min_rows: int = 2) -> LayerHooks:
    """LayerHooks that run the conv layers at res >= ``min_res`` on this
    rank's row blocks of ``mesh`` (1-D: ``axis`` names its one axis, as in
    JAX).  ``min_rows`` floors the blocks to at least that many rows per
    rank: levels below ``min_rows * world_size`` rows stay replicated.  The
    keys are JAX's: ``b{res}.conv0`` and ``b{res}.conv1`` (only conv1 at
    4x4), each with a "post" slot (:class:`RowShard`)."""
    layout = RowLayout(mesh)
    n_dev = mesh.world_size
    hooks: LayerHooks = {}
    for res in cfg.block_resolutions:
        if res < min_res or res < min_rows * n_dev:
            continue
        for layer in (["conv0", "conv1"] if res > 4 else ["conv1"]):
            hooks[f"b{res}.{layer}"] = {"post": RowShard(layout)}
    return hooks


def merge_hooks(base: Optional[LayerHooks],
                extra: LayerHooks) -> LayerHooks:
    """Compose two hook trees; where both define the same slot, ``base``
    runs first and ``extra`` wraps its result.  A row layout carried by
    either slot survives the composition."""
    if not base:
        return extra
    merged: LayerHooks = {k: dict(v) for k, v in base.items()}
    for lname, slots in extra.items():
        dst = merged.setdefault(lname, {})
        for kind, fn in slots.items():
            dst[kind] = _Chain(dst[kind], fn) if kind in dst else fn
    return merged


def d_spatial_constraint(mesh, axis: str = "data", min_rows: int = 2):
    """The discriminator's counterpart (``discriminator_apply``'s
    ``spatial_constraint``): a block whose input has at least
    ``min_rows * world_size`` rows runs on this rank's row blocks, and a
    smaller one on the whole map, gathered and replicated (JAX's
    replication floor)."""
    return DSpatialConstraint(RowLayout(mesh), min_rows)


def spatial_synthesis_fn(g_cfg: sg2.GeneratorConfig, mesh,
                         axis: str = "data", min_res: int = 256,
                         base_hooks: Optional[LayerHooks] = None):
    """``fn(params, ws) -> img``: the synthesis network (``noise_mode=
    "const"``) with the layers at res >= ``min_res`` on row blocks of
    ``mesh``, ``params`` and ``ws`` whole on every rank; ``img`` is this
    rank's row block of the image (the whole image where the last block is
    not sharded).  :func:`gather_rows` gives the whole image."""
    hooks = merge_hooks(base_hooks,
                        spatial_sharding_hooks(g_cfg.synthesis, mesh, axis,
                                               min_res))

    def fn(params, ws):
        return sg2.synthesis_apply(g_cfg.synthesis, params["synthesis"], ws,
                                   noise_mode="const", hooks=hooks,
                                   rows_out=True)

    return fn


def gather_rows(x: torch.Tensor, mesh, h: int) -> torch.Tensor:
    """The whole ``h``-row map (e.g. the image of
    :func:`spatial_synthesis_fn`, ``h = img_resolution``) from this rank's
    row block, on every rank; a whole map passes unchanged.  Differentiable:
    the backward keeps the rank's rows of the gradient."""
    return RowLayout(mesh).gather(x, h)


def hooks_layout(hooks: Optional[LayerHooks]) -> Optional[RowLayout]:
    """The row layout that some "post" slot of ``hooks`` carries, if any."""
    for slots in (hooks or {}).values():
        lay = getattr(slots.get("post"), "row_layout", None)
        if lay is not None:
            return lay
    return None


def _sharded_over(layout: Optional[RowLayout]) -> bool:
    return layout is not None and layout.world_size > 1


def is_spatial(extra_hooks: Optional[LayerHooks], d_constraint: Any) -> bool:
    """Whether a step's hooks or D constraint shard maps over several
    ranks."""
    return (_sharded_over(hooks_layout(extra_hooks))
            or _sharded_over(getattr(d_constraint, "row_layout", None)))

