"""Offset parameterizations (port of gagan_tpu/params/offsets.py): the whole
weight-offset grammar, StyleSpace(+), Affine+ and AffineLight+, as
transforms of a separate offsets tree.

The offsets live in their own tree of tensors keyed by layer name
(``b<res>.conv0`` / ``conv1`` / ``torgb``), apart from the frozen generator
parameters; a trainer differentiates with respect to the offsets only.
:func:`make_hooks` turns (spec, offsets) into the
:data:`~gagan_tpu_torch.models.stylegan2.LayerHooks` that
``synthesis_apply`` takes.

Grammar (the JAX module's, from DissimilarDomains' networks.py:25-53):
  style offsets   : multiplicative | additive | multiplicative_w_space
                    | additive_w_space
  weight offsets  : in | out | spatial | in_spatial | out_spatial | out_in
                    | out+in | out_in_<k> | out_in_<k>_dual | out_in_<k>_<t>
                    | out_in_<k>_<t>_train_in | out_in_<k>_<t>_train_out
                    (each optionally suffixed `_additive`)
  affine offsets  : affine_out_in_<k>_<t>[_additive]         (AffineLight+)
plus the SimilarDomains ``patch_key`` aliases (``s_delta`` = additive, ...).

The random low-rank factors are drawn from ``rng`` on the JAX package's key
tree (``fold_in`` per layer, factor and term): the port's
:class:`~gagan_tpu_torch.utils.rng.Rng` gives its own numbers, and a test
that hands in a draw source backed by ``jax.random`` gets JAX's.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.stylegan2 import LayerHooks, SynthesisConfig

Params = Dict[str, Any]

_BASE_KINDS = ("in", "out", "spatial", "in_spatial", "out_spatial", "out_in")

_PLUS = re.compile(r"^out\+in(_additive)?$")
_SINGLE = re.compile(r"^out_in_([0-9]+)(_additive)?$")
_DUAL = re.compile(r"^out_in_([0-9]+)_dual(_additive)?$")
_TRAIN = re.compile(r"^out_in_([0-9]+)_([0-9]+)(_additive)?$")
_TRAIN_IN = re.compile(r"^out_in_([0-9]+)_([0-9]+)_train_in(_additive)?$")
_TRAIN_OUT = re.compile(r"^out_in_([0-9]+)_([0-9]+)_train_out(_additive)?$")
_AFFINE = re.compile(r"^affine_out_in_([0-9]+)_([0-9]+)(_additive)?$")


@dataclasses.dataclass(frozen=True)
class WeightOffsetDesc:
    """Parsed weight-offset parametrization."""

    kind: str                   # 'base' | 'plus' | 'lowrank'
    additive: bool
    base_kind: Optional[str] = None          # for kind == 'base'
    rank: int = 0                            # for 'lowrank'
    terms: int = 1
    train_in: bool = True                    # which factors are trainable
    train_out: bool = True
    random_in: bool = False                  # which factors init ~ N(0,1)
    random_out: bool = False
    dual: bool = False
    normalize_terms: bool = True             # divide the sum by #terms
    affine: bool = False                     # applies to the style-affine FC


def parse_weight_parametrization(name: str) -> WeightOffsetDesc:
    base = name[: -len("_additive")] if name.endswith("_additive") else name
    additive = name.endswith("_additive")
    if base in _BASE_KINDS:
        return WeightOffsetDesc(kind="base", additive=additive, base_kind=base)
    if _PLUS.match(name):
        return WeightOffsetDesc(kind="plus", additive=additive)
    m = _AFFINE.match(name)
    if m:
        # AffineLight+: both factors trainable, in ~ N(0,1) row-normalized,
        # out zeros, the sum of terms not divided by their count.
        return WeightOffsetDesc(
            kind="lowrank", additive=additive, rank=int(m.group(1)),
            terms=int(m.group(2)), random_in=True, normalize_terms=False,
            affine=True)
    m = _DUAL.match(name)
    if m:
        return WeightOffsetDesc(
            kind="lowrank", additive=additive, rank=int(m.group(1)), terms=2,
            dual=True)
    m = _TRAIN_IN.match(name)
    if m:
        return WeightOffsetDesc(
            kind="lowrank", additive=additive, rank=int(m.group(1)),
            terms=int(m.group(2)), train_out=False, random_out=True)
    m = _TRAIN_OUT.match(name)
    if m:
        return WeightOffsetDesc(
            kind="lowrank", additive=additive, rank=int(m.group(1)),
            terms=int(m.group(2)), train_in=False, random_in=True)
    m = _TRAIN.match(name)
    if m:
        return WeightOffsetDesc(
            kind="lowrank", additive=additive, rank=int(m.group(1)),
            terms=int(m.group(2)), random_in=True)
    m = _SINGLE.match(name)
    if m:
        return WeightOffsetDesc(
            kind="lowrank", additive=additive, rank=int(m.group(1)), terms=1)
    raise ValueError(f"Unknown weight parametrization: {name}")


_STYLE_KINDS = (
    "multiplicative",
    "additive",
    "multiplicative_w_space",
    "additive_w_space",
)

# SimilarDomains patch_key names -> the grammar above.
_PATCH_KEY_ALIASES = {
    "s_delta": "additive",
    "s_mod": "multiplicative",
    "w_delta": "additive_w_space",
    "w_mod": "multiplicative_w_space",
    "cin_mult": "in",
    "cout_mult": "out",
    "cfull_mult": "out_in",
}


@dataclasses.dataclass(frozen=True)
class OffsetsSpec:
    """Which offsets exist and how they apply: one style, one weights and
    one affine parametrization at most; ``weight_parts`` gates the layers
    that get weight offsets (``all``, ``synt_weights_offset``,
    ``tRGB_weights_offset``, or either with ``.b<res>``)."""

    style: Optional[str] = None
    weights: Optional[str] = None
    affine_weights: Optional[str] = None
    weight_parts: Tuple[str, ...] = ("all",)

    def __post_init__(self):
        if self.style is not None and self.style not in _STYLE_KINDS:
            raise ValueError(f"Unknown style parametrization: {self.style}")
        if self.weights is not None:
            parse_weight_parametrization(self.weights)
        if (self.affine_weights is not None and not
                parse_weight_parametrization(self.affine_weights).affine):
            raise ValueError(f"Not an affine parametrization: "
                             f"{self.affine_weights}")

    @classmethod
    def from_string(cls, parametrization: str,
                    weight_parts: Tuple[str, ...] = ("all",)) -> "OffsetsSpec":
        """Parse the comma-separated grammar (patch_key aliases allowed)."""
        found = {"style": None, "weights": None, "affine_weights": None}
        for part in parametrization.split(","):
            part = _PATCH_KEY_ALIASES.get(part.strip(), part.strip())
            if not part:
                continue
            slot = ("style" if part in _STYLE_KINDS else "affine_weights"
                    if part.startswith("affine_") else "weights")
            if found[slot] is not None:
                raise ValueError(f"at most one {slot} parametrization: "
                                 f"{parametrization!r}")
            found[slot] = part
        return cls(weight_parts=weight_parts, **found)

    @property
    def per_sample_only(self) -> bool:
        """True when every hook acts on per-sample tensors (styles, w), never
        on the shared conv or affine weights: then a frozen and an offsets
        forward can share one batched synthesis pass
        (``make_hooks(batch_select=...)``)."""
        return self.weights is None and self.affine_weights is None

    def layer_has_weight_offsets(self, layer_name: str) -> bool:
        if self.weights is None:
            return False
        res = layer_name.split(".")[0].lstrip("b")
        part = ("tRGB_weights_offset" if layer_name.endswith("torgb")
                else "synt_weights_offset")
        return ("all" in self.weight_parts or part in self.weight_parts
                or f"{part}.b{res}" in self.weight_parts)


# ----------------------------------------------------------------------------
# Initialization


def _normalize_factor(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Unit rows (dim=1) / columns (dim=0) for a random factor; a zero
    factor stays zero."""
    normed = x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return torch.where(torch.linalg.vector_norm(x) > 1e-6, normed, x)


def _init_lowrank(rng, desc: WeightOffsetDesc, out_dim: int, in_dim: int,
                  device) -> Params:
    p: Params = {}
    for idx in range(desc.terms):
        if desc.dual:
            # WO = A1 @ B1 + A2 @ B2: B1 (in_0) a random buffer, B2 (in_1)
            # trainable zeros; A1 (out_0) trainable zeros, A2 (out_1) random.
            random_in, random_out = idx == 0, idx == 1
        else:
            random_in, random_out = desc.random_in, desc.random_out
        f_in = (rng.fold_in(2 * idx).normal((desc.rank, in_dim), device)
                if random_in else torch.zeros((desc.rank, in_dim)))
        f_out = (rng.fold_in(2 * idx + 1).normal((out_dim, desc.rank), device)
                 if random_out else torch.zeros((out_dim, desc.rank)))
        p[f"weights_offset_in_{idx}"] = _normalize_factor(f_in.to(device), 1)
        p[f"weights_offset_out_{idx}"] = _normalize_factor(f_out.to(device), 0)
    return p


def _weight_offset_params(rng, desc: WeightOffsetDesc, out_ch: int,
                          in_ch: int, k: int, device) -> Params:
    if desc.kind == "base":
        shape = {
            "in": (1, in_ch, 1, 1),
            "out": (out_ch, 1, 1, 1),
            "spatial": (1, 1, k, k),
            "in_spatial": (1, in_ch, k, k),
            "out_spatial": (out_ch, 1, k, k),
            "out_in": (out_ch, in_ch, 1, 1),
        }[desc.base_kind]
        return {"weights_offset": torch.zeros(shape, device=device)}
    if desc.kind == "plus":
        return {"weights_offset_in_0": torch.zeros((1, in_ch), device=device),
                "weights_offset_out_0": torch.zeros((out_ch, 1),
                                                    device=device)}
    return _init_lowrank(rng, desc, out_ch, in_ch, device)


def init_offsets(rng, cfg: SynthesisConfig, spec: OffsetsSpec,
                 device="cpu") -> Params:
    """The offsets tree for every synthesis layer that ``spec`` covers:
    zeros, and the random factors of the low-rank families drawn from
    ``rng`` (layer ``i`` folds ``i``, its weight offsets 1, its affine 2)."""
    offsets: Params = {}
    for i, (name, in_ch) in enumerate(zip(cfg.layer_names(),
                                          cfg.layer_in_channels())):
        lrng = rng.fold_in(i)
        layer: Params = {}
        if spec.style is not None:
            dim = cfg.w_dim if spec.style.endswith("w_space") else in_ch
            layer["offset"] = torch.zeros((1, dim), device=device)
        if spec.layer_has_weight_offsets(name):
            res = int(name.split(".")[0].lstrip("b"))
            is_rgb = name.endswith("torgb")
            layer.update(_weight_offset_params(
                lrng.fold_in(1), parse_weight_parametrization(spec.weights),
                cfg.img_channels if is_rgb else cfg.channels(res), in_ch,
                1 if is_rgb else 3, device))
        if spec.affine_weights is not None:
            layer["affine"] = _init_lowrank(
                lrng.fold_in(2),
                parse_weight_parametrization(spec.affine_weights),
                in_ch, cfg.w_dim, device)
        if layer:
            offsets[name] = layer
    return offsets


def trainable_mask(spec: OffsetsSpec, offsets: Params) -> Params:
    """True for trainable leaves, False for the frozen random factors of
    the dual / train_in / train_out families."""
    w_desc = parse_weight_parametrization(spec.weights) if spec.weights else None

    def leaf_mask(path: Tuple[str, ...]) -> bool:
        name = path[-1]
        if "affine" in path:
            return True              # AffineLight+ trains both factors
        if w_desc is None or w_desc.kind != "lowrank":
            return True
        idx = int(name.rsplit("_", 1)[1]) if name[-1].isdigit() else 0
        if name.startswith("weights_offset_in"):
            return idx == 1 if w_desc.dual else w_desc.train_in
        if name.startswith("weights_offset_out"):
            return idx == 0 if w_desc.dual else w_desc.train_out
        return True

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return leaf_mask(path)

    return walk(offsets, ())


# ----------------------------------------------------------------------------
# Application


def _compose_weight_offset(desc: WeightOffsetDesc,
                           layer: Params) -> torch.Tensor:
    if desc.kind == "base":
        return layer["weights_offset"]
    if desc.kind == "plus":
        wo = layer["weights_offset_out_0"] + layer["weights_offset_in_0"]
        return wo[:, :, None, None]
    wo = sum(layer[f"weights_offset_out_{i}"] @ layer[f"weights_offset_in_{i}"]
             for i in range(desc.terms))
    if desc.normalize_terms:
        wo = wo / desc.terms
    return wo if desc.affine else wo[:, :, None, None]


def make_hooks(spec: OffsetsSpec, offsets: Params,
               batch_select: Optional[torch.Tensor] = None) -> LayerHooks:
    """The LayerHooks of ``offsets`` under ``spec``:
      style mult : s * (1 + offset)        style add : s + offset
      weight mult: (1 + WO) * w            weight add: w + WO
    and the affine offsets as (WO, mode) for ``fc_apply``.

    ``batch_select`` (an [N] bool tensor) gates the per-sample hooks so that
    only the selected samples get the offsets, ``where(select, hooked,
    raw)``: the joint frozen + trainable synthesis pass.  It needs a
    per-sample-only spec (weight offsets are shared by the batch)."""
    hooks: LayerHooks = {}
    w_desc = parse_weight_parametrization(spec.weights) if spec.weights else None
    a_desc = (parse_weight_parametrization(spec.affine_weights)
              if spec.affine_weights else None)
    if batch_select is not None:
        if not spec.per_sample_only:
            raise ValueError(
                "batch_select needs a per-sample-only (style / w-space) "
                "spec; weight offsets apply to batch-shared weights")
        select = batch_select.to(torch.bool)[:, None]

    def gate(fn):
        if batch_select is None:
            return fn
        return lambda s, f=fn: torch.where(select, f(s), s)

    for name, layer in offsets.items():
        h: Dict[str, Any] = {}
        if spec.style is not None and "offset" in layer:
            off = layer["offset"]
            if spec.style == "multiplicative":
                h["style"] = gate(lambda s, o=off: (1.0 + o.to(s.dtype)) * s)
            elif spec.style == "additive":
                h["style"] = gate(lambda s, o=off: s + o.to(s.dtype))
            elif spec.style == "multiplicative_w_space":
                h["w"] = gate(lambda w, o=off: (1.0 + o.to(w.dtype)) * w)
            else:
                h["w"] = gate(lambda w, o=off: w + o.to(w.dtype))
        if w_desc is not None and any(k.startswith("weights_offset")
                                      for k in layer):
            wo = _compose_weight_offset(w_desc, layer)
            if w_desc.additive:
                h["weight"] = lambda w, o=wo: w + o.to(w.dtype)
            else:
                h["weight"] = lambda w, o=wo: (1.0 + o.to(w.dtype)) * w
        if a_desc is not None and "affine" in layer:
            h["affine_weight"] = (_compose_weight_offset(a_desc,
                                                         layer["affine"]),
                                  "additive" if a_desc.additive else "mult")
        if h:
            hooks[name] = h
    return hooks
