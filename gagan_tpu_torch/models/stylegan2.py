"""StyleGAN2 generator and discriminator (port of
gagan_tpu/models/stylegan2.py).

As in the JAX module, configs are frozen dataclasses with the same field
names (so a ``g_cfg`` dict written by either package builds either config),
and every forward is a plain function over a nested dict of tensors keyed as
the JAX parameter pytree.  :class:`Generator` holds those tensors as an
``nn.Module`` whose ``state_dict()`` keys are exactly the dotted keys of
``gagan_tpu.utils.checkpoint.tree_to_flat``; :class:`Discriminator` likewise.

Levels that the JAX package sends to its Pallas kernel under
``SynthesisConfig.pallas_level`` go to the port's fused CUDA op
(ops/fused_modconv.py) under the same flag and conditions, by shape only.

Block rematerialization (``remat`` / ``remat_min_res``) runs each chosen
block under ``torch.utils.checkpoint``, as the JAX package wraps it in
``jax.checkpoint``: the block's activations are dropped after the forward
and recomputed in the backward, to first and second order.  Layer hooks
(``LayerHooks``, made by params/offsets.py) transform a synthesis layer's
w, styles, affine weight, conv weight or output, as in the JAX package.
Spatial (height) sharding over ``torch.distributed`` ranks
(parallel/spatial.py) rides on the same hooks: a "post" hook that carries a
row layout runs its layer on this rank's rows, and the discriminator's
``spatial_constraint`` does the same for its large blocks.
``noise_mode="random"`` draws each layer's noise from a key of the
caller's :class:`~gagan_tpu_torch.utils.rng.Rng` (or a key drawn from a
``torch.Generator``), folded with the layer name as the JAX package folds
its key; torch cannot reproduce JAX's threefry numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from .. import resolve_device
from ..ops import fused_modconv as fmc
from ..ops import packed as pk
from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv2d_resample import conv2d_resample
from ..ops.modulated_conv2d import demod_coefs, modulated_conv2d
from ..ops.upfirdn2d import downsample2d, setup_filter, upsample2d
from ..utils.rng import Rng, name_fold

Params = Dict[str, Any]


# ----------------------------------------------------------------------------
# Configs (field for field as gagan_tpu.models.stylegan2)


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    num_ws: Optional[int] = None
    num_layers: int = 8
    embed_features: Optional[int] = None
    layer_features: Optional[int] = None
    activation: str = "lrelu"
    lr_multiplier: float = 0.01
    w_avg_beta: Optional[float] = 0.995

    @property
    def resolved_embed_features(self) -> int:
        if self.c_dim == 0:
            return 0
        return self.embed_features if self.embed_features is not None else self.w_dim

    @property
    def resolved_layer_features(self) -> int:
        return self.layer_features if self.layer_features is not None else self.w_dim

    @property
    def features_list(self) -> List[int]:
        lf = self.resolved_layer_features
        return [self.z_dim + self.resolved_embed_features] + [lf] * (
            self.num_layers - 1) + [self.w_dim]


@dataclasses.dataclass(frozen=True)
class SynthesisConfig:
    w_dim: int = 512
    img_resolution: int = 1024
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    num_fp16_res: int = 0          # bf16 for the N highest resolutions
    conv_clamp: Optional[float] = None
    architecture: str = "skip"
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    activation: str = "lrelu"
    use_noise: bool = True
    # Exact space-to-depth reformulation of the last block (ops/packed.py).
    packed_last_block: bool = False
    # The last block's torgb and depth-to-space as one input-dilated conv
    # (else a packed 1x1 and an unpack); how many trailing blocks run packed.
    packed_fused_torgb: bool = True
    packed_tail_blocks: int = 1
    # Block rematerialization (torch.utils.checkpoint): trades recompute for
    # activation memory; remat_min_res remats only blocks at res >= it.
    remat: bool = False
    remat_min_res: Optional[int] = None
    # Route eligible stride-1 3x3 levels through the fused modconv op
    # (ops/fused_modconv.py, a CUDA kernel on the card); differentiable once.
    pallas_level: bool = False

    @property
    def block_resolutions(self) -> List[int]:
        return [2 ** i for i in range(2, int(np.log2(self.img_resolution)) + 1)]

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def bf16_resolution(self) -> int:
        return max(
            2 ** (int(np.log2(self.img_resolution)) + 1 - self.num_fp16_res), 8)

    @property
    def num_ws(self) -> int:
        n = 0
        for res in self.block_resolutions:
            n += 1 if res == 4 else 2
        return n + 1

    def layer_names(self) -> List[str]:
        """Per-layer names in the JAX package's order (conv0, conv1, torgb
        of each block; the 4x4 block has no conv0)."""
        names = []
        for res in self.block_resolutions:
            if res > 4:
                names.append(f"b{res}.conv0")
            names += [f"b{res}.conv1", f"b{res}.torgb"]
        return names

    def layer_in_channels(self) -> List[int]:
        """Input channels (= style width) of each layer of layer_names()."""
        dims = []
        for res in self.block_resolutions:
            if res > 4:
                dims.append(self.channels(res // 2))
            dims += [self.channels(res), self.channels(res)]
        return dims


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    img_resolution: int = 1024
    img_channels: int = 3
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    synthesis: SynthesisConfig = dataclasses.field(default_factory=SynthesisConfig)

    def __post_init__(self):
        s = dataclasses.replace(
            self.synthesis, w_dim=self.w_dim, img_resolution=self.img_resolution,
            img_channels=self.img_channels)
        m = dataclasses.replace(
            self.mapping, z_dim=self.z_dim, c_dim=self.c_dim, w_dim=self.w_dim,
            num_ws=s.num_ws)
        object.__setattr__(self, "mapping", m)
        object.__setattr__(self, "synthesis", s)

    @property
    def num_ws(self) -> int:
        return self.synthesis.num_ws


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    c_dim: int = 0
    img_resolution: int = 1024
    img_channels: int = 3
    architecture: str = "resnet"
    channel_base: int = 32768
    channel_max: int = 512
    num_fp16_res: int = 0
    conv_clamp: Optional[float] = None
    cmap_dim: Optional[int] = None
    activation: str = "lrelu"
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    mbstd_group_size: Optional[int] = 4
    mbstd_num_channels: int = 1
    freeze_layers: int = 0
    # Block rematerialization, as SynthesisConfig.remat / remat_min_res.
    remat: bool = False
    remat_min_res: Optional[int] = None
    # Space-to-depth first block(s) (resnet only), as in the JAX package.
    packed_first_block: bool = False
    packed_head_blocks: int = 1
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)

    @property
    def block_resolutions(self) -> List[int]:
        return [2 ** i for i in range(int(np.log2(self.img_resolution)), 2, -1)]

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def bf16_resolution(self) -> int:
        return max(
            2 ** (int(np.log2(self.img_resolution)) + 1 - self.num_fp16_res), 8)

    @property
    def resolved_cmap_dim(self) -> int:
        if self.c_dim == 0:
            return 0
        return self.cmap_dim if self.cmap_dim is not None else self.channels(4)

    def cmap_mapping(self) -> MappingConfig:
        """The conditioning mapping network's config (z_dim 0)."""
        return dataclasses.replace(
            self.mapping, z_dim=0, c_dim=self.c_dim,
            w_dim=self.resolved_cmap_dim, num_ws=None, w_avg_beta=None)


# ----------------------------------------------------------------------------
# Initialization (same shapes and rules as the JAX init; torch draws)


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _init_fc(gen, in_features: int, out_features: int,
             lr_multiplier: float = 1.0, bias_init: float = 0.0) -> Params:
    return {"weight": _normal(gen, (out_features, in_features)) / lr_multiplier,
            "bias": torch.full((out_features,), float(bias_init))}


def _init_conv(gen, in_channels: int, out_channels: int, kernel: int,
               bias: bool = True) -> Params:
    p = {"weight": _normal(gen, (out_channels, in_channels, kernel, kernel))}
    if bias:
        p["bias"] = torch.zeros((out_channels,))
    return p


def init_mapping(gen: torch.Generator, cfg: MappingConfig) -> Params:
    params: Params = {}
    feats = cfg.features_list
    for idx in range(cfg.num_layers):
        params[f"fc{idx}"] = _init_fc(gen, feats[idx], feats[idx + 1],
                                      lr_multiplier=cfg.lr_multiplier)
    if cfg.c_dim > 0:
        params["embed"] = _init_fc(gen, cfg.c_dim, cfg.resolved_embed_features)
    if cfg.num_ws is not None and cfg.w_avg_beta is not None:
        params["w_avg"] = torch.zeros((cfg.w_dim,))
    return params


def _init_synthesis_layer(gen, in_channels: int, out_channels: int, w_dim: int,
                          resolution: int, use_noise: bool) -> Params:
    p = _init_conv(gen, in_channels, out_channels, 3)
    p["affine"] = _init_fc(gen, w_dim, in_channels, bias_init=1.0)
    if use_noise:
        p["noise_const"] = _normal(gen, (resolution, resolution))
        p["noise_strength"] = torch.zeros(())
    return p


def _has_torgb(cfg: SynthesisConfig, res: int) -> bool:
    """Whether block ``res`` has a torgb layer: every block of a "skip" G,
    the last block only of an "orig" one."""
    return cfg.architecture == "skip" or res == cfg.img_resolution


def _check_architecture(cfg: SynthesisConfig):
    """"skip" and "orig" run; "resnet" is refused, because the JAX package's
    resnet G never reads its skip convolutions (ROADMAP section 3)."""
    if cfg.architecture not in ("skip", "orig"):
        raise NotImplementedError(
            f"architecture={cfg.architecture!r}: the port's G runs 'skip' "
            f"and 'orig'")


def init_synthesis(gen: torch.Generator, cfg: SynthesisConfig) -> Params:
    params: Params = {}
    for res in cfg.block_resolutions:
        block: Params = {}
        out_ch = cfg.channels(res)
        if res == 4:
            block["const"] = _normal(gen, (out_ch, res, res))
        else:
            block["conv0"] = _init_synthesis_layer(
                gen, cfg.channels(res // 2), out_ch, cfg.w_dim, res,
                cfg.use_noise)
        block["conv1"] = _init_synthesis_layer(gen, out_ch, out_ch, cfg.w_dim,
                                               res, cfg.use_noise)
        if _has_torgb(cfg, res):
            torgb = _init_conv(gen, out_ch, cfg.img_channels, 1)
            torgb["affine"] = _init_fc(gen, cfg.w_dim, out_ch, bias_init=1.0)
            block["torgb"] = torgb
        params[f"b{res}"] = block
    return params


def init_generator(cfg: GeneratorConfig, gen: torch.Generator,
                   device) -> Params:
    """Random generator parameters (JAX init shapes and rules) drawn on the
    CPU from ``gen``, then moved to ``device``."""
    params = {"mapping": init_mapping(gen, cfg.mapping),
              "synthesis": init_synthesis(gen, cfg.synthesis)}
    return tree_map(lambda t: t.to(device), params)


def init_discriminator(cfg: DiscriminatorConfig, gen: torch.Generator,
                       device) -> Params:
    """Random discriminator parameters (JAX init shapes and rules) drawn on
    the CPU from ``gen``, then moved to ``device``."""
    params: Params = {}
    for res in cfg.block_resolutions:
        block: Params = {}
        in_ch = cfg.channels(res) if res < cfg.img_resolution else 0
        tmp_ch = cfg.channels(res)
        out_ch = cfg.channels(res // 2)
        if in_ch == 0 or cfg.architecture == "skip":
            block["fromrgb"] = _init_conv(gen, cfg.img_channels, tmp_ch, 1)
        block["conv0"] = _init_conv(gen, tmp_ch, tmp_ch, 3)
        block["conv1"] = _init_conv(gen, tmp_ch, out_ch, 3)
        if cfg.architecture == "resnet":
            block["skip"] = _init_conv(gen, tmp_ch, out_ch, 1, bias=False)
        params[f"b{res}"] = block
    if cfg.c_dim > 0:
        params["mapping"] = init_mapping(gen, cfg.cmap_mapping())
    ch4 = cfg.channels(4)
    epilogue: Params = {}
    if cfg.architecture == "skip":
        epilogue["fromrgb"] = _init_conv(gen, cfg.img_channels, ch4, 1)
    epilogue["conv"] = _init_conv(gen, ch4 + cfg.mbstd_num_channels, ch4, 3)
    epilogue["fc"] = _init_fc(gen, ch4 * 16, ch4)
    epilogue["out"] = _init_fc(gen, ch4, 1 if cfg.resolved_cmap_dim == 0
                               else cfg.resolved_cmap_dim)
    params["b4"] = epilogue
    return tree_map(lambda t: t.to(device), params)


def tree_map(fn, tree: Params) -> Params:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


# ----------------------------------------------------------------------------
# Primitive layers


def fc_apply(p: Params, x: torch.Tensor, activation: str = "linear",
             lr_multiplier: float = 1.0,
             weight_offset: Optional[torch.Tensor] = None,
             weight_offset_mode: str = "none") -> torch.Tensor:
    """FullyConnectedLayer forward (equalized learning rate).
    ``weight_offset`` offsets the raw weight before the gain: added
    (``weight_offset_mode="additive"``) or as ``(1 + offset) * weight``."""
    w = p["weight"]
    if weight_offset is not None:
        w = (w + weight_offset if weight_offset_mode == "additive"
             else (1.0 + weight_offset) * w)
    w = w.to(x.dtype) * (lr_multiplier / np.sqrt(w.shape[1]))
    x = x @ w.T
    b = p.get("bias")
    if b is not None and lr_multiplier != 1.0:
        b = b * lr_multiplier
    return bias_act(x, b, act=activation)


def conv2d_layer_apply(p: Params, x: torch.Tensor, activation: str = "linear",
                       up: int = 1, down: int = 1,
                       resample_filter: Optional[torch.Tensor] = None,
                       conv_clamp: Optional[float] = None,
                       gain: float = 1.0) -> torch.Tensor:
    """Conv2dLayer forward (equalized learning rate)."""
    w = p["weight"]
    out_ch, in_ch, kh, kw = w.shape
    w = w * (1.0 / np.sqrt(in_ch * kh * kw))
    x = conv2d_resample(x, w.to(x.dtype), f=resample_filter, up=up,
                        down=down, padding=kh // 2, flip_weight=(up == 1))
    act_gain = activation_funcs[activation].def_gain * gain
    act_clamp = conv_clamp * gain if conv_clamp is not None else None
    b = p.get("bias")
    return bias_act(x, b.to(x.dtype) if b is not None else None,
                    act=activation, gain=act_gain, clamp=act_clamp)


def normalize_2nd_moment(x: torch.Tensor, dim: int = 1,
                         eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def mapping_apply(cfg: MappingConfig, params: Params, z: Optional[torch.Tensor],
                  c: Optional[torch.Tensor] = None, truncation_psi: float = 1.0,
                  truncation_cutoff: Optional[int] = None,
                  broadcast: bool = True) -> torch.Tensor:
    """MappingNetwork forward: ws [N, num_ws, w_dim] (broadcast) or [N, w_dim]."""
    x = None
    if cfg.z_dim > 0:
        x = normalize_2nd_moment(z.float())
    if cfg.c_dim > 0:
        y = normalize_2nd_moment(fc_apply(params["embed"], c.float()))
        x = torch.cat([x, y], dim=1) if x is not None else y

    for idx in range(cfg.num_layers):
        x = fc_apply(params[f"fc{idx}"], x, activation=cfg.activation,
                     lr_multiplier=cfg.lr_multiplier)

    if broadcast and cfg.num_ws is not None:
        x = x[:, None, :].repeat(1, cfg.num_ws, 1)

    if truncation_psi != 1.0:
        w_avg = params["w_avg"]
        if cfg.num_ws is None or truncation_cutoff is None:
            x = w_avg + truncation_psi * (x - w_avg)
        else:
            head = w_avg + truncation_psi * (x[:, :truncation_cutoff] - w_avg)
            x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
    return x


# Per-layer transform hooks: {layer name: {kind: callable}}, the kinds being
# "w" (the layer's w vectors), "style" (its styles), "weight" (its conv
# weight), "post" (the conv output, before noise and bias) and
# "affine_weight", which is an (offset, mode) pair for fc_apply.
LayerHooks = Dict[str, Dict[str, Any]]


def _hook(hooks: Optional[LayerHooks], layer_name: str, kind: str):
    return hooks.get(layer_name, {}).get(kind) if hooks else None


def _layer_styles(lp: Params, w: torch.Tensor, weight_gain: float = 1.0,
                  layer_name: str = "",
                  hooks: Optional[LayerHooks] = None) -> torch.Tensor:
    """w -> styles: the affine layer, with the layer's hooks."""
    fn = _hook(hooks, layer_name, "w")
    if fn is not None:
        w = fn(w)
    offset, mode = _hook(hooks, layer_name, "affine_weight") or (None, "none")
    styles = fc_apply(lp["affine"], w, weight_offset=offset,
                      weight_offset_mode=mode)
    if weight_gain != 1.0:
        styles = styles * weight_gain
    fn = _hook(hooks, layer_name, "style")
    return styles if fn is None else fn(styles)


def _layer_weight(lp: Params, layer_name: str,
                  hooks: Optional[LayerHooks]) -> torch.Tensor:
    fn = _hook(hooks, layer_name, "weight")
    return lp["weight"] if fn is None else fn(lp["weight"])


def _noise(cfg: SynthesisConfig, lp: Params, noise_mode: str, shape,
           rng: Optional[Rng], name: str, rows=None) -> Optional[torch.Tensor]:
    """Scaled layer noise: [H, W] for const, ``shape`` for random (drawn
    from ``rng`` folded with the layer name).  With a row layout ``rows``
    (parallel/spatial.py): this rank's rows of it, the random draw made at
    the global shape on every rank from the same key."""
    if not cfg.use_noise or noise_mode == "none":
        return None
    strength = lp["noise_strength"]
    if noise_mode == "const":
        nz = lp["noise_const"]
    else:
        nz = rng.fold_in(name_fold(name)).normal(shape, device=strength.device)
        nz = nz.to(strength.device)
    if rows is not None:
        nz = rows.rows(nz, shape[-2])
        (strength,) = rows.enter(strength)
    return nz * strength


def _row_layout(hooks: Optional[LayerHooks], layer_name: str):
    """The row layout (parallel/spatial.py) that the layer's "post" hook
    carries when it shards the layer over several ranks, else None."""
    lay = getattr(_hook(hooks, layer_name, "post"), "row_layout", None)
    return lay if lay is not None and lay.world_size > 1 else None


def synthesis_layer_apply(cfg: SynthesisConfig, lp: Params, x: torch.Tensor,
                          w: torch.Tensor, resolution: int, up: int,
                          resample_filter: torch.Tensor, layer_name: str,
                          noise_mode: str = "const",
                          rng: Optional[Rng] = None,
                          hooks: Optional[LayerHooks] = None) -> torch.Tensor:
    """SynthesisLayer forward.  The fused level takes the hooked styles and
    weight; a "post" hook keeps the layer on the composed path.  A "post"
    hook that carries a row layout (parallel/spatial.py) runs the layer on
    this rank's rows: ``x`` is the input map whole or as this rank's rows,
    and the output is this rank's rows."""
    lay = _row_layout(hooks, layer_name)
    styles = _layer_styles(lp, w, 1.0, layer_name, hooks)
    weight = _layer_weight(lp, layer_name, hooks)
    noise = _noise(cfg, lp, noise_mode, (x.shape[0], 1, resolution, resolution),
                   rng, layer_name, lay)
    post = _hook(hooks, layer_name, "post")
    if lay is not None:
        return _synthesis_layer_rows(cfg, lay, lp, x, styles, weight, noise,
                                     resolution, up, resample_filter, post)

    if (cfg.pallas_level and up == 1 and cfg.activation == "lrelu"
            and post is None
            and fmc.supported_shape(tuple(x.shape), tuple(weight.shape))):
        nz = noise
        if nz is not None and nz.ndim == 2:      # const buffer [H, W]
            nz = nz[None, None].expand(x.shape[0], 1, *nz.shape).contiguous()
        return fmc.fused_modconv_level(
            x, weight, styles, lp["bias"], noise=nz,
            act_gain=activation_funcs[cfg.activation].def_gain,
            clamp=cfg.conv_clamp)

    x = modulated_conv2d(x, weight, styles, up=up,
                         padding=weight.shape[-1] // 2,
                         resample_filter=resample_filter,
                         flip_weight=(up == 1))
    if post is not None:
        x = post(x)
    if noise is not None:
        x = x + noise.to(x.dtype)
    return bias_act(x, lp["bias"].to(x.dtype), act=cfg.activation,
                    gain=activation_funcs[cfg.activation].def_gain,
                    clamp=cfg.conv_clamp)


def _synthesis_layer_rows(cfg: SynthesisConfig, lay, lp: Params,
                          x: torch.Tensor, styles: torch.Tensor,
                          weight: torch.Tensor, noise, resolution: int,
                          up: int, resample_filter: torch.Tensor,
                          post) -> torch.Tensor:
    """A synthesis layer on this rank's rows: the composed modulated conv on
    the input's window (its rows and a halo of kernel // 2 rows, of the
    low-resolution input before an up=2 conv), the window's extra output
    rows cropped; noise, bias, activation and clamp are row-local."""
    styles, weight, bias = lay.enter(styles, weight, lp["bias"])
    halo = weight.shape[-1] // 2
    x = lay.window(x, resolution // up, halo)
    x = modulated_conv2d(x, weight, styles, up=up,
                         padding=weight.shape[-1] // 2,
                         resample_filter=resample_filter,
                         flip_weight=(up == 1))
    x = post(lay.crop(x, halo * up, resolution))
    if noise is not None:
        x = x + noise.to(x.dtype)
    return bias_act(x, bias.to(x.dtype), act=cfg.activation,
                    gain=activation_funcs[cfg.activation].def_gain,
                    clamp=cfg.conv_clamp)


def torgb_layer_apply(cfg: SynthesisConfig, lp: Params, x: torch.Tensor,
                      w: torch.Tensor, layer_name: str = "",
                      hooks: Optional[LayerHooks] = None,
                      rows=None) -> torch.Tensor:
    """ToRGBLayer forward (1x1, no demodulation).  With a row layout
    ``rows`` (parallel/spatial.py), ``x`` is this rank's rows and so is the
    output."""
    in_ch = lp["weight"].shape[1]
    kernel = lp["weight"].shape[-1]
    styles = _layer_styles(lp, w, 1.0 / np.sqrt(in_ch * kernel ** 2),
                           layer_name, hooks)
    weight, bias = _layer_weight(lp, layer_name, hooks), lp["bias"]
    if rows is not None:
        styles, weight, bias = rows.enter(styles, weight, bias)
    x = modulated_conv2d(x, weight, styles, demodulate=False)
    post = _hook(hooks, layer_name, "post")
    if post is not None:
        x = post(x)
    return bias_act(x, bias.to(x.dtype), clamp=cfg.conv_clamp)


def _upsample_rows(lay, img: torch.Tensor, f: torch.Tensor,
                   resolution: int) -> torch.Tensor:
    """``upsample2d`` of the skip image (whole or this rank's rows) to this
    rank's rows at ``resolution``: a window with a halo of one row."""
    return lay.crop(upsample2d(lay.window(img, resolution // 2, 1), f), 2,
                    resolution)


def _packed_tail(cfg: SynthesisConfig, params: Params,
                 tail: List[Tuple[int, List[torch.Tensor]]], x: torch.Tensor,
                 img: Optional[torch.Tensor], noise_mode: str,
                 rng: Optional[Rng], force_fp32: bool,
                 hooks: Optional[LayerHooks] = None) -> torch.Tensor:
    """The trailing synthesis blocks ``tail`` ([(res, block_ws)]) on the
    2x2-packed grid (exact; ops/packed.py): returns the image.  The feature
    map enters unpacked and each block's conv0 packs it by the composed
    up-conv; before a later block's conv0 it is unpacked again, as the JAX
    package does (the stay-packed crossing kernel carries 4x structural
    zeros).  An unfused torgb is a block-diagonal 1x1 over the four cells,
    with the skip image upsampled straight into the packed layout; with
    ``packed_fused_torgb`` the last block's torgb and the depth-to-space
    are one input-dilated conv to the image.  Takes every hook kind but
    "post" (which keeps the blocks unpacked)."""
    taps = torch.as_tensor(cfg.resample_filter, dtype=torch.float32,
                           device=x.device)
    taps = taps / taps.sum()
    spec = activation_funcs[cfg.activation]
    batch = x.shape[0]

    def add_noise_act(lp, name, res, h, out_ch):
        nz = _noise(cfg, lp, noise_mode, (batch, 1, res, res), rng,
                    f"b{res}.{name}")
        if nz is not None:
            nz = pk.pack(nz[None, None] if nz.ndim == 2 else nz)
            h = h + nz.repeat_interleave(out_ch, dim=1).to(h.dtype)
        bias = pk.pack_channel_tile(lp["bias"])
        return bias_act(h, bias.to(h.dtype), act=cfg.activation,
                        gain=spec.def_gain, clamp=cfg.conv_clamp)

    def styles_weight(block, res, name, w, gain=1.0):
        lp = block[name]
        return (_layer_styles(lp, w, gain, f"b{res}.{name}", hooks),
                _layer_weight(lp, f"b{res}.{name}", hooks))

    packed = False
    for bi, (res, block_ws) in enumerate(tail):
        block = params[f"b{res}"]
        dtype = (torch.bfloat16 if res >= cfg.bf16_resolution and not force_fp32
                 else torch.float32)
        x = x.to(dtype)
        if packed:
            x = pk.unpack(x)

        # conv0 (up=2): unpacked input -> packed output, composed up-conv.
        styles, weight = styles_weight(block, res, "conv0", block_ws[0])
        d = demod_coefs(weight, styles)
        wp = pk.build_packed_upconv(weight, taps)
        h = x * styles.to(x.dtype)[:, :, None, None]
        h = pk.conv_packed(h, wp.to(dtype))
        h = h * pk.pack_channel_tile(d).to(h.dtype)[:, :, None, None]
        h = add_noise_act(block["conv0"], "conv0", res, h, weight.shape[0])
        packed = True

        # conv1: packed -> packed.
        styles, weight = styles_weight(block, res, "conv1", block_ws[1])
        d = demod_coefs(weight, styles)
        wp = pk.build_packed_conv3x3(weight)
        h = h * pk.pack_channel_tile(styles).to(h.dtype)[:, :, None, None]
        h = pk.conv_packed(h, wp.to(dtype))
        h = h * pk.pack_channel_tile(d).to(h.dtype)[:, :, None, None]
        h = add_noise_act(block["conv1"], "conv1", res, h, weight.shape[0])

        lp = block["torgb"]
        styles, weight = styles_weight(
            block, res, "torgb", block_ws[2],
            1.0 / np.sqrt(lp["weight"].shape[1]))
        y = h * pk.pack_channel_tile(styles).to(h.dtype)[:, :, None, None]
        if img is not None and bi > 0:
            img = pk.unpack(img)
        if cfg.packed_fused_torgb and bi == len(tail) - 1:
            # torgb 1x1 + depth-to-space as one input-dilated conv.
            krgb = pk.build_torgb_transposed(weight[:, :, 0, 0])
            y = pk.conv_transposed_unpack(y, krgb.to(dtype))
            y = bias_act(y, lp["bias"].to(y.dtype), clamp=cfg.conv_clamp).float()
            return y if img is None else upsample2d(img, taps) + y
        y = pk.conv_packed(y, pk.build_packed_conv1x1(weight).to(dtype))
        y = bias_act(y, pk.pack_channel_tile(lp["bias"]).to(y.dtype),
                     clamp=cfg.conv_clamp).float()
        img = y if img is None else pk.fir_upsample_packed(img, taps) + y
        x = h
    return pk.unpack(img)


def _want_remat(cfg, res: int) -> bool:
    """Block-level remat decision: cfg.remat remats everything;
    cfg.remat_min_res remats only blocks at res >= the threshold."""
    if cfg.remat:
        return True
    return cfg.remat_min_res is not None and res >= cfg.remat_min_res


def _remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward.  The
    blocks draw no random numbers of their own (layer noise comes from an
    ``Rng`` key fixed before the block), so the recomputation sees the same
    values without saving the global RNG state."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def synthesis_apply(cfg: SynthesisConfig, params: Params, ws: torch.Tensor,
                    noise_mode: str = "const",
                    generator: "Optional[torch.Generator | Rng]" = None,
                    force_fp32: bool = False,
                    hooks: Optional[LayerHooks] = None,
                    rows_out: bool = False) -> torch.Tensor:
    """SynthesisNetwork forward: ws [N, num_ws, w_dim] -> img [N, C, R, R].
    ``noise_mode="random"`` draws from ``generator``: an :class:`Rng` key,
    or a ``torch.Generator`` that one key is drawn from.  With
    ``packed_last_block`` the ``packed_tail_blocks`` trailing blocks of a
    "skip" G run packed; an "orig" G has a torgb in its last block only
    and runs unpacked.  ``hooks`` are the layers' transforms; a "post" hook
    on a layer of the packed tail keeps all its blocks unpacked, and with
    hooks the packed tail is not rematerialized (other blocks still are),
    as in the JAX package.

    Spatial sharding (parallel/spatial.py): a block whose conv1 "post" hook
    carries a row layout runs its layers, torgb and the skip image's
    upsampling on this rank's rows, and the image is gathered whole at the
    end; with ``rows_out`` this rank's rows of it are returned instead."""
    if noise_mode not in ("random", "const", "none"):
        raise ValueError(f"noise_mode must be random, const or none, "
                         f"got {noise_mode!r}")
    rng = generator
    if noise_mode == "random":
        if generator is None:
            raise ValueError("noise_mode='random' needs a torch.Generator "
                             "or an Rng")
        if isinstance(generator, torch.Generator):
            rng = Rng.from_generator(generator)
    _check_architecture(cfg)
    resolutions = cfg.block_resolutions
    n_tail = 0
    if cfg.packed_last_block and cfg.architecture == "skip":
        # Up to packed_tail_blocks trailing blocks, never the 4x4 one.
        n_tail = max(0, min(cfg.packed_tail_blocks, len(resolutions) - 1))
        if hooks and any(_hook(hooks, f"b{r}.{name}", "post")
                         for r in resolutions[len(resolutions) - n_tail:]
                         for name in ("conv0", "conv1", "torgb")):
            n_tail = 0
    tail_start = resolutions[-n_tail] if n_tail else None

    resample_filter = setup_filter(cfg.resample_filter, device=ws.device)
    batch = ws.shape[0]
    ws = ws.float()
    x = img = None
    w_idx = 0
    for res in resolutions:
        block = params[f"b{res}"]
        dtype = (torch.bfloat16 if res >= cfg.bf16_resolution and not force_fp32
                 else torch.float32)
        num_conv = 1 if res == 4 else 2
        block_ws = [ws[:, w_idx + i] for i in range(num_conv + 1)]
        w_idx += num_conv
        # The sharded blocks are the highest ones (spatial_sharding_hooks):
        # once a block runs on rows, every later one does, the last too.
        lay = _row_layout(hooks, f"b{res}.conv1")

        if res == tail_start:
            tail_res = resolutions[resolutions.index(res):]
            tail_ws = [block_ws] + [
                [ws[:, w_idx + 2 * i + j] for j in range(3)]
                for i in range(len(tail_res) - 1)]

            def tail_fn(params, x, img, tail_ws):
                return _packed_tail(cfg, params, list(zip(tail_res, tail_ws)),
                                    x, img, noise_mode, rng, force_fp32, hooks)
            if _want_remat(cfg, res) and hooks is None:
                return _remat(tail_fn, params, x, img, tail_ws)
            return tail_fn(params, x, img, tail_ws)

        def block_fn(block, x, img, block_ws, res=res, dtype=dtype,
                     num_conv=num_conv, lay=lay):
            if res == 4:
                x = block["const"].to(dtype)[None].repeat(batch, 1, 1, 1)
            else:
                x = synthesis_layer_apply(cfg, block["conv0"], x.to(dtype),
                                          block_ws[0], res, 2,
                                          resample_filter, f"b{res}.conv0",
                                          noise_mode, rng, hooks)
            x = synthesis_layer_apply(cfg, block["conv1"], x,
                                      block_ws[num_conv - 1], res, 1,
                                      resample_filter, f"b{res}.conv1",
                                      noise_mode, rng, hooks)
            if img is not None:
                img = (upsample2d(img, resample_filter) if lay is None else
                       _upsample_rows(lay, img, resample_filter, res))
            if "torgb" in block:
                y = torgb_layer_apply(cfg, block["torgb"], x,
                                      block_ws[num_conv], f"b{res}.torgb",
                                      hooks, lay).float()
                img = y if img is None else img + y
            return x, img

        if _want_remat(cfg, res):
            x, img = _remat(block_fn, block, x, img, block_ws)
        else:
            x, img = block_fn(block, x, img, block_ws)
    if lay is not None and not rows_out:
        img = lay.gather(img, resolutions[-1])
    return img


def generator_apply(cfg: GeneratorConfig, params: Params, z: torch.Tensor,
                    c: Optional[torch.Tensor] = None,
                    truncation_psi: float = 1.0,
                    truncation_cutoff: Optional[int] = None,
                    noise_mode: str = "const",
                    generator: "Optional[torch.Generator | Rng]" = None,
                    force_fp32: bool = False,
                    hooks: Optional[LayerHooks] = None) -> torch.Tensor:
    """z [N, z_dim] -> img [N, img_channels, R, R] in float32."""
    ws = mapping_apply(cfg.mapping, params["mapping"], z, c,
                       truncation_psi=truncation_psi,
                       truncation_cutoff=truncation_cutoff)
    return synthesis_apply(cfg.synthesis, params["synthesis"], ws,
                           noise_mode=noise_mode, generator=generator,
                           force_fp32=force_fp32, hooks=hooks)


def generator_styles(cfg: SynthesisConfig, params: Params, ws: torch.Tensor,
                     hooks: Optional[LayerHooks] = None) -> List[torch.Tensor]:
    """Per-layer styles in layer_names() order (S space); the torgb styles
    include their weight gain, as the forward applies it."""
    styles = []
    w_idx = 0
    for res in cfg.block_resolutions:
        block = params[f"b{res}"]
        num_conv = 1 if res == 4 else 2
        convs = ["conv1"] if res == 4 else ["conv0", "conv1"]
        for i, name in enumerate(convs):
            styles.append(_layer_styles(block[name], ws[:, w_idx + i], 1.0,
                                        f"b{res}.{name}", hooks))
        if _has_torgb(cfg, res):
            lp = block["torgb"]
            gain = 1.0 / np.sqrt(lp["weight"].shape[1]
                                 * lp["weight"].shape[-1] ** 2)
            styles.append(_layer_styles(lp, ws[:, w_idx + num_conv], gain,
                                        f"b{res}.torgb", hooks))
        w_idx += num_conv
    return styles


def synthesis_from_styles(cfg: SynthesisConfig, params: Params,
                          styles: List[torch.Tensor],
                          noise_mode: str = "const",
                          generator: "Optional[torch.Generator | Rng]" = None,
                          hooks: Optional[LayerHooks] = None) -> torch.Tensor:
    """The synthesis forward from explicit per-layer styles (S space, in
    layer_names() order, the torgb styles with their weight gain as
    :func:`generator_styles` gives them).  Composed ops in float32 on the
    unpacked blocks, as the JAX function is: the fused level, bf16 and the
    packed tail are not taken.  Weight hooks apply; the styles are taken
    as given."""
    if noise_mode not in ("random", "const", "none"):
        raise ValueError(f"noise_mode must be random, const or none, "
                         f"got {noise_mode!r}")
    _check_architecture(cfg)
    rng = generator
    if noise_mode == "random" and isinstance(generator, torch.Generator):
        rng = Rng.from_generator(generator)
    styles = list(styles)
    batch = styles[0].shape[0]
    resample_filter = setup_filter(cfg.resample_filter,
                                   device=styles[0].device)
    spec = activation_funcs[cfg.activation]

    def layer_fwd(lp, x, s, res, up, name, demodulate=True):
        weight = _layer_weight(lp, name, hooks)
        noise = (_noise(cfg, lp, noise_mode, (batch, 1, res, res), rng, name)
                 if demodulate else None)
        x = modulated_conv2d(x, weight, s, up=up, padding=weight.shape[-1] // 2,
                             resample_filter=resample_filter if up > 1 else None,
                             demodulate=demodulate, flip_weight=(up == 1))
        if noise is not None:
            x = x + noise.to(x.dtype)
        if demodulate:
            return bias_act(x, lp["bias"].to(x.dtype), act=cfg.activation,
                            gain=spec.def_gain, clamp=cfg.conv_clamp)
        return bias_act(x, lp["bias"].to(x.dtype), clamp=cfg.conv_clamp)

    idx = 0
    x = img = None
    for res in cfg.block_resolutions:
        block = params[f"b{res}"]
        if res == 4:
            x = block["const"].float()[None].repeat(batch, 1, 1, 1)
        else:
            x = layer_fwd(block["conv0"], x, styles[idx], res, 2,
                          f"b{res}.conv0")
            idx += 1
        x = layer_fwd(block["conv1"], x, styles[idx], res, 1, f"b{res}.conv1")
        idx += 1
        if img is not None:
            img = upsample2d(img, resample_filter)
        if _has_torgb(cfg, res):
            y = layer_fwd(block["torgb"], x, styles[idx], res, 1,
                          f"b{res}.torgb", demodulate=False).float()
            idx += 1
            img = y if img is None else img + y
    return img


# ----------------------------------------------------------------------------
# Discriminator


def minibatch_std(x: torch.Tensor, group_size: Optional[int],
                  num_channels: int = 1, shard=None) -> torch.Tensor:
    """MinibatchStdLayer: append the per-group feature stddev channels.

    A group takes sample i with i +- N/g of the global batch, so with the
    batch split over ranks (``shard``, a ``parallel.mesh.BatchShard``) the
    statistic is taken over every rank's rows and each rank keeps its own."""
    xg = x if shard is None else shard.gather(x)
    n, c, h, w = xg.shape
    g = min(group_size, n) if group_size is not None else n
    f = num_channels
    y = xg.reshape(g, -1, f, c // f, h, w).float()
    y = y - y.mean(dim=0)
    y = y.square().mean(dim=0)
    y = torch.sqrt(y + 1e-8)
    y = y.mean(dim=(2, 3, 4))
    y = y.reshape(-1, f, 1, 1).to(x.dtype)
    y = y.repeat(g, 1, h, w)
    if shard is not None:
        y = shard.take(y)
    return torch.cat([x, y], dim=1)


def _equalized(w: torch.Tensor) -> torch.Tensor:
    o, i, kh, kw = w.shape
    return w * (1.0 / np.sqrt(i * kh * kw))


def _packed_res_core(cfg: DiscriminatorConfig, block: Params, x: torch.Tensor,
                     dtype: torch.dtype, lay=None) -> torch.Tensor:
    """conv0/conv1/skip of a resnet block on the packed grid (ops/packed.py):
    ``x`` is the packed input [N, 4C, res/2, res/2]; returns the unpacked
    [N, C_out, res/2, res/2] block output.  With a row layout ``lay``
    (parallel/spatial.py), ``x`` is this rank's rows of the packed grid, each
    3x3 conv takes a window with a halo of one packed row, and the output is
    this rank's rows."""
    taps = torch.as_tensor(cfg.resample_filter, dtype=torch.float32,
                           device=x.device)
    taps = taps / taps.sum()
    spec = activation_funcs[cfg.activation]

    def conv(v, wp):
        if lay is None:
            return pk.conv_packed(v, wp.to(dtype))
        h = v.shape[-2] * lay.world_size
        return lay.crop(pk.conv_packed(lay.window(v, h, 1), wp.to(dtype)),
                        1, h)

    y = conv(x, pk.build_packed_conv3x3(_equalized(block["conv0"]["weight"])))
    y = bias_act(y, pk.pack_channel_tile(block["conv0"]["bias"]).to(y.dtype),
                 act=cfg.activation, gain=spec.def_gain, clamp=cfg.conv_clamp)
    y = conv(y, pk.build_packed_downconv(_equalized(block["conv1"]["weight"]),
                                         taps))
    g = float(np.sqrt(0.5))
    y = bias_act(y, block["conv1"]["bias"].to(y.dtype), act=cfg.activation,
                 gain=spec.def_gain * g,
                 clamp=cfg.conv_clamp * g if cfg.conv_clamp else None)
    sk = conv(x, pk.build_packed_down1x1(_equalized(block["skip"]["weight"]),
                                         taps))
    sk = sk * torch.full((), g, dtype=sk.dtype, device=sk.device)
    return sk + y


def _d_block(cfg: DiscriminatorConfig, block: Params, x, img,
             resample_filter, dtype, lay=None, res: Optional[int] = None):
    if lay is not None:
        return _d_block_rows(cfg, lay, lay.enter_tree(block), x, img,
                             resample_filter, dtype, res)
    if x is not None:
        x = x.to(dtype)
    if "fromrgb" in block:
        y = conv2d_layer_apply(block["fromrgb"], img.to(dtype), cfg.activation,
                               conv_clamp=cfg.conv_clamp)
        x = x + y if x is not None else y
        img = (downsample2d(img, resample_filter)
               if cfg.architecture == "skip" else None)
    if cfg.architecture == "resnet":
        y = conv2d_layer_apply(block["skip"], x, "linear", down=2,
                               resample_filter=resample_filter,
                               gain=float(np.sqrt(0.5)))
        x = conv2d_layer_apply(block["conv0"], x, cfg.activation,
                               conv_clamp=cfg.conv_clamp)
        x = conv2d_layer_apply(block["conv1"], x, cfg.activation, down=2,
                               resample_filter=resample_filter,
                               conv_clamp=cfg.conv_clamp,
                               gain=float(np.sqrt(0.5)))
        x = y + x
    else:
        x = conv2d_layer_apply(block["conv0"], x, cfg.activation,
                               conv_clamp=cfg.conv_clamp)
        x = conv2d_layer_apply(block["conv1"], x, cfg.activation, down=2,
                               resample_filter=resample_filter,
                               conv_clamp=cfg.conv_clamp)
    return x, img


def _d_block_rows(cfg: DiscriminatorConfig, lay, block: Params, x, img,
                  resample_filter, dtype, res: int):
    """:func:`_d_block` on this rank's rows of its ``res``-row input
    (parallel/spatial.py): ``x`` is those rows (or None), ``img`` the whole
    image, ``block`` the entered parameters.  Each conv runs on a window of
    its input, a halo of one row before a 3x3 conv and two before a stride-2
    op, and keeps the rank's rows of its output."""

    def conv(p, v, act, halo, down=1, **kw):
        y = conv2d_layer_apply(p, v, act, down=down,
                               resample_filter=resample_filter if down > 1
                               else None, **kw)
        return lay.crop(y, halo // down, res // down)

    if x is not None:
        x = x.to(dtype)
    if "fromrgb" in block:
        y = conv(block["fromrgb"], lay.rows(img, res).to(dtype),
                 cfg.activation, 0, conv_clamp=cfg.conv_clamp)
        x = x + y if x is not None else y
        img = (downsample2d(img, resample_filter)
               if cfg.architecture == "skip" else None)
    g = float(np.sqrt(0.5))
    if cfg.architecture == "resnet":
        xw = lay.window(x, res, 2, stride2=True)
        y = conv(block["skip"], xw, "linear", 2, down=2, gain=g)
        x = conv(block["conv0"], xw[..., 1:-1, :], cfg.activation, 1,
                 conv_clamp=cfg.conv_clamp)
        x = conv(block["conv1"], lay.window(x, res, 2, stride2=True),
                 cfg.activation, 2, down=2, conv_clamp=cfg.conv_clamp, gain=g)
        return y + x, img
    x = conv(block["conv0"], lay.window(x, res, 1), cfg.activation, 1,
             conv_clamp=cfg.conv_clamp)
    x = conv(block["conv1"], lay.window(x, res, 2, stride2=True),
             cfg.activation, 2, down=2, conv_clamp=cfg.conv_clamp)
    return x, img


def discriminator_apply(cfg: DiscriminatorConfig, params: Params,
                        img: torch.Tensor, c: Optional[torch.Tensor] = None,
                        force_fp32: bool = False,
                        spatial_constraint=None, shard=None) -> torch.Tensor:
    """Discriminator forward: img [N, C, R, R] -> logits [N, 1] in float32.

    ``shard`` (a ``parallel.mesh.BatchShard``): ``img`` is this rank's
    share of a global batch, and the minibatch stddev reads every rank's.
    ``spatial_constraint``: from ``parallel.spatial.d_spatial_constraint``,
    ``img`` is whole on every rank and each block whose input has at least
    ``min_rows`` rows a rank runs on this rank's rows (the packed first
    block on an even row block with halos on the packed grid); smaller
    blocks and the epilogue run on the gathered map.  Any other callable is
    applied to the image, to each unpacked block's input and to the last
    block's output, as the JAX package applies it."""
    resample_filter = setup_filter(cfg.resample_filter, device=img.device)
    spec = activation_funcs[cfg.activation]
    lay = getattr(spatial_constraint, "row_layout", None)
    if lay is not None and lay.world_size == 1:
        spatial_constraint = lay = None
    constrain = (spatial_constraint if lay is None and spatial_constraint
                 is not None else (lambda t: t))
    img = constrain(img)

    def first_block_packed(block, img, dtype, lay=None):
        """fromrgb 1x1 as a cell-diagonal conv on pack(img), then the
        packed conv0/conv1/skip core; with ``lay``, on this rank's rows."""
        if lay is not None:
            block = lay.enter_tree(block)
            img = lay.rows(img, cfg.img_resolution)
        w = pk.build_packed_conv1x1(_equalized(block["fromrgb"]["weight"]))
        h = pk.conv_packed(pk.pack(img.to(dtype)), w.to(dtype))
        h = bias_act(h, pk.pack_channel_tile(
            block["fromrgb"]["bias"]).to(h.dtype), act=cfg.activation,
            gain=spec.def_gain, clamp=cfg.conv_clamp)
        return _packed_res_core(cfg, block, h, dtype, lay)

    def head_block_packed(block, x, dtype, lay=None, res=None):
        if lay is not None:
            block, x = lay.enter_tree(block), lay.rows(x, res)
        return _packed_res_core(cfg, block, pk.pack(x.to(dtype)), dtype, lay)

    def d_block(block, x, img, dtype, lay=None, res=None):
        return _d_block(cfg, block, x, img, resample_filter, dtype, lay, res)

    x = None
    x_rows = None        # the layout x is this rank's rows in, if any
    for bi, res in enumerate(cfg.block_resolutions):
        block = params[f"b{res}"]
        dtype = (torch.bfloat16 if res >= cfg.bf16_resolution and not force_fp32
                 else torch.float32)
        run = _remat if _want_remat(cfg, res) else (lambda fn, *a: fn(*a))
        packed_ok = (cfg.packed_first_block and res > 4
                     and cfg.architecture == "resnet"
                     and bi < cfg.packed_head_blocks)
        rows = (lay if lay is not None and spatial_constraint.sharded(res)
                else None)
        if x_rows is not None and rows is None:
            x = x_rows.gather(x, res)
        if rows is not None:
            rows.block(res, stride2=True)
        if packed_ok and res == cfg.img_resolution:
            x = run(first_block_packed, block, img, dtype, rows)
            img = None
        elif packed_ok:
            x = run(head_block_packed, block, x, dtype, rows, res)
        else:
            if x is not None:
                x = constrain(x)
            x, img = run(d_block, block, x, img, dtype, rows, res)
        x_rows = rows
    if x_rows is not None:
        x = x_rows.gather(x, cfg.block_resolutions[-1] // 2)
    x = constrain(x)

    cmap = None
    if cfg.c_dim > 0:
        cmap = mapping_apply(cfg.cmap_mapping(), params["mapping"], None, c,
                             broadcast=False)

    # Epilogue.
    ep = params["b4"]
    x = x.float()
    if cfg.architecture == "skip":
        x = x + conv2d_layer_apply(ep["fromrgb"], img.float(), cfg.activation)
    if cfg.mbstd_num_channels > 0:
        x = minibatch_std(x, cfg.mbstd_group_size, cfg.mbstd_num_channels,
                          shard)
    x = conv2d_layer_apply(ep["conv"], x, cfg.activation,
                           conv_clamp=cfg.conv_clamp)
    x = fc_apply(ep["fc"], x.reshape(x.shape[0], -1), activation=cfg.activation)
    x = fc_apply(ep["out"], x)
    if cfg.resolved_cmap_dim > 0:
        x = (x * cmap).sum(dim=1, keepdim=True) * (
            1.0 / np.sqrt(cfg.resolved_cmap_dim))
    return x


# ----------------------------------------------------------------------------
# nn.Module holders


# Leaves that StyleGAN2 keeps as buffers rather than trainable parameters.
_BUFFERS = ("w_avg", "noise_const")


class _Tree(nn.Module):
    """A nested parameter dict as modules: state_dict keys are dotted paths."""

    def __init__(self, tree: Params):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            elif k in _BUFFERS:
                self.register_buffer(k, v)
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> Params:
        out: Params = {k: m.tree() for k, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        out.update(self.named_buffers(recurse=False))
        return out


class _Network(nn.Module):
    """A parameter tree as a module: its top-level keys are child modules,
    ``state_dict()`` keys are the JAX package's ``tree_to_flat`` keys."""

    def __init__(self, cfg, device, params: Params):
        super().__init__()
        self.cfg = cfg
        for k, v in params.items():
            self.add_module(k, _Tree(v))
        self.to(resolve_device(device))

    def params(self) -> Params:
        return {k: m.tree() for k, m in self.named_children()}

    def load_flat(self, flat: Dict[str, np.ndarray]) -> "_Network":
        """Copy a flat {dotted key: array} dict in; the key sets must match."""
        own = self.state_dict()
        missing, extra = set(own) - set(flat), set(flat) - set(own)
        if missing or extra:
            raise KeyError(f"weight keys differ: missing {sorted(missing)}, "
                           f"unexpected {sorted(extra)}")
        with torch.no_grad():
            for k, t in own.items():
                src = torch.as_tensor(np.array(flat[k]))
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"{k}: shape {tuple(src.shape)} != "
                                     f"{tuple(t.shape)}")
                t.copy_(src)
        return self



class Generator(_Network):
    """The generator's parameters as a module; ``forward`` is
    :func:`generator_apply` over them.  ``state_dict()`` keys equal the keys
    of the JAX package's ``tree_to_flat(init_generator(...))``."""

    def __init__(self, cfg: GeneratorConfig, device, seed: int = 0,
                 params: Optional[Params] = None):
        resolve_device(device)
        if params is None:
            params = init_generator(cfg, torch.Generator().manual_seed(seed),
                                    "cpu")
        super().__init__(cfg, device, params)

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                **kwargs) -> torch.Tensor:
        return generator_apply(self.cfg, self.params(), z, c, **kwargs)


class Discriminator(_Network):
    """The discriminator's parameters as a module; ``forward`` is
    :func:`discriminator_apply` over them.  ``state_dict()`` keys equal the
    keys of the JAX package's ``tree_to_flat(init_discriminator(...))``."""

    def __init__(self, cfg: DiscriminatorConfig, device, seed: int = 0,
                 params: Optional[Params] = None):
        resolve_device(device)
        if params is None:
            params = init_discriminator(
                cfg, torch.Generator().manual_seed(seed), "cpu")
        super().__init__(cfg, device, params)

    def forward(self, img: torch.Tensor, c: Optional[torch.Tensor] = None,
                **kwargs) -> torch.Tensor:
        return discriminator_apply(self.cfg, self.params(), img, c, **kwargs)
