"""Spatial (height) sharding of high-resolution synthesis and of the
discriminator (port of gagan_tpu/parallel/spatial.py).

At 1024^2 the activation maps, not the batch, fill a card's memory.  The
JAX module shards the H axis of the large maps over its mesh with
numeric-identity ``with_sharding_constraint`` hooks and lets XLA insert the
halo exchanges.  Nothing inserts them here: every rank of a
:class:`~gagan_tpu_torch.parallel.mesh.Mesh` (one process each) holds the
whole global batch, replicated state, and of each sharded map only its
rows, and the layers exchange their edge rows themselves.

Layout (JAX's ``P(None, None, axis, None)``): rank ``r`` of ``n`` holds one
contiguous row block of a sharded ``[N, C, H, W]`` map, every sample:
``H // n`` rows, one more on each of the first ``H % n`` ranks, so that any
number of ranks splits any map of at least ``n`` rows (XLA pads uneven
shards instead; the numbers are the same).  Each level of a network has its
own blocks.  Mapping, styles, the blocks below the sharded resolutions, D's
epilogue and the losses run whole on every rank.

Each sharded layer takes a window of its input: the rows that this rank's
block of its OUTPUT needs (its own rows, up to ``k`` more on each side, and
for an up- or down-sampling op the rows of the input level under that
block), fetched from whichever ranks hold them (zero rows outside the
image); it runs the port's composed op on the window with its usual
padding and keeps the rows of its block (:meth:`RowLayout.window`,
:meth:`RowLayout.crop`).  So a level's blocks need not line up with the
next level's: an odd first row in front of a stride-2 op, or over three
ranks a first block of 86 of 256 rows under one of 171 of 512 rows (not
2 * 86), only moves the window.

The collectives are ``torch.autograd.Function`` pairs whose backward is the
other of the pair, so that R1 and path-length regularisation differentiate
through them twice:

* the window exchange and its adjoint, which sends the gradients of the
  window's rows that other ranks own back to them and adds them there;
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
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models import stylegan2 as sg2
from ..models.stylegan2 import LayerHooks

# Collectives issued by this module since the last reset_stats(): "exchanges"
# (all of them), "bytes" (the bytes a rank handed to them), and counts by
# kind: "halo" (window exchanges and their adjoints), "enter" (the gradient
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


class _Fetch(torch.autograd.Function):
    """Rows ``wins[rank]`` of an ``h``-row map from each rank's block (zero
    rows outside the map); its adjoint is :class:`_FetchReturn`."""

    @staticmethod
    def forward(ctx, x, layout, h, wins):
        ctx.args = (layout, h, wins)
        return layout._fetch(x, h, wins)

    @staticmethod
    def backward(ctx, g):
        return (_FetchReturn.apply(g, *ctx.args),) + (None,) * 3


class _FetchReturn(torch.autograd.Function):
    """The adjoint of :class:`_Fetch`: a window's gradient, its rows sent
    back to the ranks that own them and added into those rows."""

    @staticmethod
    def forward(ctx, g, layout, h, wins):
        ctx.args = (layout, h, wins)
        return layout._fetch_return(g, h, wins)

    @staticmethod
    def backward(ctx, g):
        return (_Fetch.apply(g, *ctx.args),) + (None,) * 3


# ----------------------------------------------------------------------------
# The row layout


@functools.lru_cache(maxsize=None)
def row_blocks(h: int, n: int) -> Tuple[Tuple[int, int], ...]:
    """(first row, end row) of each of ``n`` ranks' blocks of an ``h``-row
    map: ``h // n`` rows each, one more for each of the first ``h % n``
    ranks.  Raises for a map of fewer rows than ranks."""
    if h < n:
        raise ValueError(f"spatial sharding over {n} ranks: a {h}-row map "
                         f"has fewer rows than ranks")
    q, extra = divmod(h, n)
    blocks, s = [], 0
    for r in range(n):
        e = s + q + (r < extra)
        blocks.append((s, e))
        s = e
    return tuple(blocks)


@functools.lru_cache(maxsize=None)
def op_windows(h: int, out_h: int, k: int, n: int):
    """For each of ``n`` ranks, ((a, b), offset): the rows ``[a, b)`` of an
    ``h``-row input that an op onto an ``out_h``-row output (``h``, ``2h``
    or ``h / 2`` rows) reaching ``k`` input rows past its centre needs for
    the rank's output block, and the row of the op's output on that window
    where the block starts (the op's output row ``j`` on a window from row
    ``a`` is the map's row ``a * out_h / h + j``)."""
    out = []
    for s, e in row_blocks(out_h, n):
        if out_h == h:
            a, b = s - k, e + k
        elif out_h == 2 * h:
            a, b = s // 2 - k, (e + 1) // 2 + k
        elif 2 * out_h == h and k % 2 == 0:
            a, b = 2 * s - k, 2 * e + k
        else:
            raise ValueError(f"no row window of an op from {h} to {out_h} "
                             f"rows reaching {k} rows")
        out.append(((a, b), s - a * out_h // h))
    return tuple(out)


def _outside(win, block):
    """The parts of the window ``[a, b)`` before and after the block
    ``[s, e)``, as two (first, end) row ranges (empty ones have first ==
    end)."""
    (a, b), (s, e) = win, block
    return (a, max(a, min(b, s))), (min(b, max(a, e)), b)


class RowLayout:
    """The row blocks of the maps sharded over ``mesh``'s ranks
    (:func:`row_blocks`), and the operations of a layer on them.  A map of
    ``h`` rows is this rank's block when it holds the block's rows, and
    whole (replicated) when it holds ``h``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.world_size = mesh.world_size if mesh.sharded else 1
        self.rank = mesh.rank if mesh.sharded else 0

    def blocks(self, h: int):
        """Every rank's (first row, end row) of an ``h``-row map."""
        return row_blocks(h, self.world_size)

    def block(self, h: int):
        """(first row, end row) of this rank's block of an ``h``-row map."""
        return self.blocks(h)[self.rank]

    def is_rows(self, x: torch.Tensor, h: int) -> bool:
        """Whether ``x`` (of a map of ``h`` rows) is this rank's block
        (False: the whole map)."""
        if x.shape[-2] == h:
            return False
        s, e = self.block(h)
        if x.shape[-2] != e - s:
            raise ValueError(f"a tensor of {x.shape[-2]} rows is neither a "
                             f"{h}-row map nor rank {self.rank}'s block of "
                             f"it ({e - s} rows of {self.world_size} ranks' "
                             f"blocks)")
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

    def windows(self, x: torch.Tensor, h: int, *ops):
        """For each op ``(k, out_h)`` on the ``h``-row map ``x`` (whole, or
        this rank's block), (window, offset) as :func:`op_windows` gives
        them: the window's rows, zero outside the map, from one exchange
        for all the ops, or sliced out of the whole map."""
        specs = [op_windows(h, out_h, k, self.world_size) for k, out_h in ops]
        wins = tuple((min(sp[r][0][0] for sp in specs),
                      max(sp[r][0][1] for sp in specs))
                     for r in range(self.world_size))
        a, b = wins[self.rank]
        if not self.is_rows(x, h):
            (x,) = self.enter(x)
            piece = x[..., max(a, 0):min(b, h), :]
            xw = F.pad(piece, (0, 0, max(-a, 0), max(b - h, 0)))
        elif any(lo != hi for w, blk in zip(wins, self.blocks(h))
                 for lo, hi in _outside(w, blk)):
            xw = _Fetch.apply(x, self, h, wins)
        else:
            s = self.block(h)[0]
            xw = x[..., a - s:b - s, :]
        out = []
        for sp in specs:
            (lo, hi), offset = sp[self.rank]
            out.append((xw[..., lo - a:hi - a, :], offset))
        return out

    def window(self, x: torch.Tensor, h: int, k: int,
               out_h: Optional[int] = None):
        """(window, offset) of one op (:meth:`windows`); ``out_h``
        defaults to ``h``."""
        return self.windows(x, h, (k, out_h or h))[0]

    def rows(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """This rank's block of a map whole on every rank (or the block
        itself)."""
        return self.window(x, h, 0)[0]

    def crop(self, y: torch.Tensor, offset: int, h: int) -> torch.Tensor:
        """This rank's block of the ``h``-row output map from an op's
        output on a window, the block starting at row ``offset``."""
        s, e = self.block(h)
        return y[..., offset:offset + e - s, :]

    def gather(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """The whole ``h``-row map from every rank's block (the map itself
        when it is whole already).  Its backward keeps the rank's rows of
        the gradient."""
        if not self.is_rows(x, h):
            return x
        s, e = self.block(h)
        return _AllReduce.apply(F.pad(x, (0, 0, s, h - e)), self.mesh)

    def _buffer(self, t, h, wins):
        """A zero-filled [world_size, ..., rows, W] buffer whose slot j
        holds the rows of rank j's window outside j's block (those before
        it, then those after it), the two parts of each rank's window, and
        the rows a slot keeps for the first part."""
        parts = [_outside(w, blk) for w, blk in zip(wins, self.blocks(h))]
        before = max(e - s for (s, e), _ in parts)
        after = max(e - s for _, (s, e) in parts)
        buf = t.new_zeros((self.world_size,) + tuple(t.shape[:-2])
                          + (before + after, t.shape[-1]))
        return buf, parts, before

    def _owned(self, parts, before, h):
        """(slot, its rows, the block's rows) of each piece of the ranks'
        windows that this rank's block holds."""
        s, e = self.block(h)
        for j, (pre, post) in enumerate(parts):
            for (lo, hi), base in ((pre, pre[0]), (post, post[0] - before)):
                lo, hi = max(lo, s), min(hi, e)
                if lo < hi:
                    yield j, slice(lo - base, hi - base), slice(lo - s, hi - s)

    def _fetch(self, x, h, wins):
        """Each rank hands the rows of the ranks' windows that its block
        holds to one all_reduce of a zero-filled buffer; this rank's window
        is its own rows between the ones it received."""
        x = x.detach()
        buf, parts, before = self._buffer(x, h, wins)
        for j, rows, mine in self._owned(parts, before, h):
            buf[j][..., rows, :] = x[..., mine, :]
        _all_reduce(self.mesh, buf, "halo")
        (a, b), (s, e) = wins[self.rank], self.block(h)
        (p0, p1), (q0, q1) = parts[self.rank]
        slot = buf[self.rank]
        return torch.cat([slot[..., :p1 - p0, :],
                          x[..., p1 - s:max(q0, p1) - s, :],
                          slot[..., before:before + q1 - q0, :]], -2)

    def _fetch_return(self, g, h, wins):
        g = g.detach()
        a, (s, e) = wins[self.rank][0], self.block(h)
        buf, parts, before = self._buffer(g, h, wins)
        (p0, p1), (q0, q1) = parts[self.rank]
        buf[self.rank][..., :p1 - p0, :] = g[..., :p1 - p0, :]
        buf[self.rank][..., before:before + q1 - q0, :] = g[..., q0 - a:, :]
        _all_reduce(self.mesh, buf, "halo")
        dx = g.new_zeros(tuple(g.shape[:-2]) + (e - s, g.shape[-1]))
        dx[..., p1 - s:max(q0, p1) - s, :] = g[..., p1 - a:max(q0, p1) - a, :]
        for j, rows, mine in self._owned(parts, before, h):
            dx[..., mine, :] += buf[j][..., rows, :]
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

