"""StyleGAN2 generator and discriminator, the composed path alone (frozen
copy of the port's models/stylegan2.py, cut to what the benchmark's
reference runs: an unconditional "skip" G and "resnet" D, unpacked, with
no fused level and in one process).

Configs are frozen dataclasses with the port's field names, and every
forward is a plain function over a nested dict of tensors keyed as the
port's parameter tree.  Block rematerialization (``remat`` /
``remat_min_res``) runs each chosen block under ``torch.utils.checkpoint``.
Layer hooks (``LayerHooks``, made by params/offsets.py) transform a
synthesis layer's w, styles, affine weight, conv weight or output.
``noise_mode="random"`` draws each layer's noise from a key of the
caller's :class:`~..utils.rng.Rng`, folded with the layer name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..ops import conv2d_gradfix
from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv2d_resample import conv2d_resample
from ..ops.modulated_conv2d import modulated_conv2d
from ..ops.upfirdn2d import setup_filter, upsample2d
from ..utils.rng import Rng, name_fold

Params = Dict[str, Any]


# ----------------------------------------------------------------------------
# Configs (field for field as gagan_tpu.models.stylegan2)


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    z_dim: int = 512
    w_dim: int = 512
    num_ws: Optional[int] = None
    num_layers: int = 8
    activation: str = "lrelu"
    lr_multiplier: float = 0.01
    w_avg_beta: Optional[float] = 0.995

    @property
    def features_list(self) -> List[int]:
        return [self.z_dim] + [self.w_dim] * (self.num_layers - 1) + [
            self.w_dim]


@dataclasses.dataclass(frozen=True)
class SynthesisConfig:
    w_dim: int = 512
    img_resolution: int = 1024
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    num_fp16_res: int = 0          # bf16 for the N highest resolutions
    conv_clamp: Optional[float] = None
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    activation: str = "lrelu"
    use_noise: bool = True
    # Block rematerialization (torch.utils.checkpoint): trades recompute for
    # activation memory; remat_min_res remats only blocks at res >= it.
    remat: bool = False
    # The control's rounding (not in the package): blocks at res >= this
    # round their convolutions' operands to fp8 (ops/conv2d_gradfix.py).
    fp8_resolution: Optional[int] = None
    remat_min_res: Optional[int] = None

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
            self.mapping, z_dim=self.z_dim, w_dim=self.w_dim, num_ws=s.num_ws)
        object.__setattr__(self, "mapping", m)
        object.__setattr__(self, "synthesis", s)

    @property
    def num_ws(self) -> int:
        return self.synthesis.num_ws


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    img_resolution: int = 1024
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    num_fp16_res: int = 0
    conv_clamp: Optional[float] = None
    activation: str = "lrelu"
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    mbstd_group_size: Optional[int] = 4
    mbstd_num_channels: int = 1
    # Block rematerialization, as SynthesisConfig.remat / remat_min_res.
    remat: bool = False
    # The control's rounding (not in the package): blocks at res >= this
    # round their convolutions' operands to fp8 (ops/conv2d_gradfix.py).
    fp8_resolution: Optional[int] = None
    remat_min_res: Optional[int] = None

    @property
    def block_resolutions(self) -> List[int]:
        return [2 ** i for i in range(int(np.log2(self.img_resolution)), 2, -1)]

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def bf16_resolution(self) -> int:
        return max(
            2 ** (int(np.log2(self.img_resolution)) + 1 - self.num_fp16_res), 8)



# ----------------------------------------------------------------------------
# Initialization (same shapes and rules as the JAX init; torch draws)


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


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
        if in_ch == 0:
            block["fromrgb"] = _init_conv(gen, cfg.img_channels, tmp_ch, 1)
        block["conv0"] = _init_conv(gen, tmp_ch, tmp_ch, 3)
        block["conv1"] = _init_conv(gen, tmp_ch, out_ch, 3)
        block["skip"] = _init_conv(gen, tmp_ch, out_ch, 1, bias=False)
        params[f"b{res}"] = block
    ch4 = cfg.channels(4)
    epilogue: Params = {}
    epilogue["conv"] = _init_conv(gen, ch4 + cfg.mbstd_num_channels, ch4, 3)
    epilogue["fc"] = _init_fc(gen, ch4 * 16, ch4)
    epilogue["out"] = _init_fc(gen, ch4, 1)
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
    x, w = conv2d_gradfix.rounded(conv2d_gradfix.Rounding.fc, x, w)
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


def mapping_apply(cfg: MappingConfig, params: Params, z: torch.Tensor,
                  broadcast: bool = True) -> torch.Tensor:
    """MappingNetwork forward: ws [N, num_ws, w_dim] (broadcast) or [N, w_dim]."""
    x = normalize_2nd_moment(z.float())
    for idx in range(cfg.num_layers):
        x = fc_apply(params[f"fc{idx}"], x, activation=cfg.activation,
                     lr_multiplier=cfg.lr_multiplier)

    if broadcast and cfg.num_ws is not None:
        x = x[:, None, :].repeat(1, cfg.num_ws, 1)
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
           rng: Optional[Rng], name: str) -> Optional[torch.Tensor]:
    """Scaled layer noise: [H, W] for const, ``shape`` for random (drawn
    from ``rng`` folded with the layer name)."""
    if not cfg.use_noise or noise_mode == "none":
        return None
    strength = lp["noise_strength"]
    if noise_mode == "const":
        nz = lp["noise_const"]
    else:
        nz = rng.fold_in(name_fold(name)).normal(shape, device=strength.device)
        nz = nz.to(strength.device)
    return nz * strength


def synthesis_layer_apply(cfg: SynthesisConfig, lp: Params, x: torch.Tensor,
                          w: torch.Tensor, resolution: int, up: int,
                          resample_filter: torch.Tensor, layer_name: str,
                          noise_mode: str = "const",
                          rng: Optional[Rng] = None,
                          hooks: Optional[LayerHooks] = None) -> torch.Tensor:
    """SynthesisLayer forward."""
    styles = _layer_styles(lp, w, 1.0, layer_name, hooks)
    weight = _layer_weight(lp, layer_name, hooks)
    noise = _noise(cfg, lp, noise_mode, (x.shape[0], 1, resolution, resolution),
                   rng, layer_name)
    post = _hook(hooks, layer_name, "post")
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


def torgb_layer_apply(cfg: SynthesisConfig, lp: Params, x: torch.Tensor,
                      w: torch.Tensor, layer_name: str = "",
                      hooks: Optional[LayerHooks] = None) -> torch.Tensor:
    """ToRGBLayer forward (1x1, no demodulation)."""
    in_ch = lp["weight"].shape[1]
    kernel = lp["weight"].shape[-1]
    styles = _layer_styles(lp, w, 1.0 / np.sqrt(in_ch * kernel ** 2),
                           layer_name, hooks)
    weight, bias = _layer_weight(lp, layer_name, hooks), lp["bias"]
    x = modulated_conv2d(x, weight, styles, demodulate=False)
    post = _hook(hooks, layer_name, "post")
    if post is not None:
        x = post(x)
    return bias_act(x, bias.to(x.dtype), clamp=cfg.conv_clamp)


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
                    generator: Optional[Rng] = None,
                    hooks: Optional[LayerHooks] = None) -> torch.Tensor:
    """SynthesisNetwork forward: ws [N, num_ws, w_dim] -> img [N, C, R, R].
    ``noise_mode="random"`` draws from ``generator``, an :class:`Rng` key;
    ``hooks`` are the layers' transforms."""
    if noise_mode not in ("random", "const", "none"):
        raise ValueError(f"noise_mode must be random, const or none, "
                         f"got {noise_mode!r}")
    if noise_mode == "random" and generator is None:
        raise ValueError("noise_mode='random' needs an Rng")
    rng = generator
    resolutions = cfg.block_resolutions

    resample_filter = setup_filter(cfg.resample_filter, device=ws.device)
    batch = ws.shape[0]
    ws = ws.float()
    x = img = None
    w_idx = 0
    for res in resolutions:
        block = params[f"b{res}"]
        dtype = (torch.bfloat16 if res >= cfg.bf16_resolution
                 else torch.float32)
        num_conv = 1 if res == 4 else 2
        block_ws = [ws[:, w_idx + i] for i in range(num_conv + 1)]
        w_idx += num_conv

        def block_fn(block, x, img, block_ws, res=res, dtype=dtype,
                     num_conv=num_conv):
            prev = conv2d_gradfix.Rounding.block
            conv2d_gradfix.Rounding.block = (
                "fp8" if cfg.fp8_resolution is not None
                and res >= cfg.fp8_resolution else None)
            try:
                return _block(block, x, img, block_ws, res, dtype, num_conv)
            finally:
                conv2d_gradfix.Rounding.block = prev

        def _block(block, x, img, block_ws, res, dtype, num_conv):
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
                img = upsample2d(img, resample_filter)
            y = torgb_layer_apply(cfg, block["torgb"], x, block_ws[num_conv],
                                  f"b{res}.torgb", hooks).float()
            img = y if img is None else img + y
            return x, img

        if _want_remat(cfg, res):
            x, img = _remat(block_fn, block, x, img, block_ws)
        else:
            x, img = block_fn(block, x, img, block_ws)
    return img


def generator_apply(cfg: GeneratorConfig, params: Params, z: torch.Tensor,
                    noise_mode: str = "const",
                    generator: Optional[Rng] = None,
                    hooks: Optional[LayerHooks] = None) -> torch.Tensor:
    """z [N, z_dim] -> img [N, img_channels, R, R] in float32."""
    ws = mapping_apply(cfg.mapping, params["mapping"], z)
    return synthesis_apply(cfg.synthesis, params["synthesis"], ws,
                           noise_mode=noise_mode, generator=generator,
                           hooks=hooks)


# ----------------------------------------------------------------------------
# Discriminator


def minibatch_std(x: torch.Tensor, group_size: Optional[int],
                  num_channels: int = 1) -> torch.Tensor:
    """MinibatchStdLayer: append the per-group feature stddev channels (a
    group takes sample i with i +- N/g)."""
    xg = x
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
    return torch.cat([x, y], dim=1)


def _d_block(cfg: DiscriminatorConfig, block: Params, x, img,
             resample_filter, dtype):
    """A resnet D block; the first takes the image through its fromrgb."""
    if x is not None:
        x = x.to(dtype)
    if "fromrgb" in block:
        y = conv2d_layer_apply(block["fromrgb"], img.to(dtype), cfg.activation,
                               conv_clamp=cfg.conv_clamp)
        x = x + y if x is not None else y
    y = conv2d_layer_apply(block["skip"], x, "linear", down=2,
                           resample_filter=resample_filter,
                           gain=float(np.sqrt(0.5)))
    x = conv2d_layer_apply(block["conv0"], x, cfg.activation,
                           conv_clamp=cfg.conv_clamp)
    x = conv2d_layer_apply(block["conv1"], x, cfg.activation, down=2,
                           resample_filter=resample_filter,
                           conv_clamp=cfg.conv_clamp,
                           gain=float(np.sqrt(0.5)))
    return y + x


def discriminator_apply(cfg: DiscriminatorConfig, params: Params,
                        img: torch.Tensor) -> torch.Tensor:
    """Discriminator forward: img [N, C, R, R] -> logits [N, 1] in float32."""
    resample_filter = setup_filter(cfg.resample_filter, device=img.device)

    def d_block(block, x, img, dtype, res):
        prev = conv2d_gradfix.Rounding.block
        conv2d_gradfix.Rounding.block = (
            "fp8" if cfg.fp8_resolution is not None
            and res >= cfg.fp8_resolution else None)
        try:
            return _d_block(cfg, block, x, img, resample_filter, dtype)
        finally:
            conv2d_gradfix.Rounding.block = prev

    x = None
    for res in cfg.block_resolutions:
        block = params[f"b{res}"]
        dtype = (torch.bfloat16 if res >= cfg.bf16_resolution
                 else torch.float32)
        run = _remat if _want_remat(cfg, res) else (lambda fn, *a: fn(*a))
        x = run(d_block, block, x, img, dtype, res)

    # Epilogue.
    ep = params["b4"]
    x = x.float()
    if cfg.mbstd_num_channels > 0:
        x = minibatch_std(x, cfg.mbstd_group_size, cfg.mbstd_num_channels)
    x = conv2d_layer_apply(ep["conv"], x, cfg.activation,
                           conv_clamp=cfg.conv_clamp)
    x = fc_apply(ep["fc"], x.reshape(x.shape[0], -1), activation=cfg.activation)
    return fc_apply(ep["out"], x)

