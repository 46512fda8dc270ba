"""ADA augmentation pipeline (port of gagan_tpu/train/augment.py).

Pixel blitting and general geometric transforms compose into one inverse
homogeneous 3x3 matrix per sample, executed as the reference pyramid: a
reflect pad by the data-dependent margin, a 2x wavelet upsample, one bilinear
resample and a 2x wavelet downsample.  Color transforms compose into one
4x4 matrix; then image-space filtering, additive noise and cutout.  All
probability gating is ``torch.where`` over per-sample draws.

The geometric step runs one of the JAX module's two branches, chosen by
``geom_mode``: "exact" is its eager pyramid (the data-dependent margin is
read to the host: one sync per call); "fast" is the native-resolution warp
of train/warp.py behind a static reflect margin (``jit_margin_divisor``),
which the JAX package runs whenever the pipe is traced.  "auto" resolves as
the JAX module resolves it: the train step, the loop and ``cli/train.py``
take the pipe through :func:`make_augment_fn`, which stands where JAX jits
it and so resolves "auto" to "fast"; a direct call of :func:`augment_pipe`
is eager and resolves "auto" to "exact".

Every draw comes from the caller's key (utils/rng.py), split into 32 keys
and taken in the JAX module's order, so a test can inject JAX's draws.  The
JAX module has only those 32: a spec with ``imgfilter`` beside the
blit/geom/color group (bgcf, bgcfn, bgcfnc: 34-39 draws) stops with
StopIteration there.  The port goes on with 32 more keys split from
``key.fold_in(32)``, so its first 32 draws stay JAX's.
The bilinear resample is four ``torch.gather``s, which autograd
differentiates to any order with respect to the image (R1 differentiates
D(augment(x)) twice; ``F.grid_sample``'s backward is not differentiable).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.upfirdn2d import downsample2d, setup_filter, upsample2d
from ..utils.observability import trace_scope
from .warp import affine_warp

# Wavelet low-pass coefficients.
WAVELETS = {
    "haar": [0.7071067811865476, 0.7071067811865476],
    "sym2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469,
             0.48296291314469025],
    "sym6": [0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
             -0.048311742585633, 0.4910559419267466, 0.787641141030194,
             0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
             0.04472490177066578, 0.0017677118642428036, -0.007800708325034148],
}


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    # Pixel blitting.
    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    # General geometric.
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    # Color.
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    # Image-space filtering.
    imgfilter: float = 0.0
    imgfilter_bands: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    # Corruptions.
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5
    # The fast warp's static reflect margin: width // jit_margin_divisor.
    jit_margin_divisor: int = 4
    # Reduced-precision image dtype for the pipe ("bfloat16") or None.
    compute_dtype: Optional[str] = None
    # "exact": the 2x-pyramid grid sample; "fast": the native-resolution
    # warp (train/warp.py) behind a static margin, zeros past it; "auto":
    # "fast" in the train step (make_augment_fn), "exact" in a direct call
    # of augment_pipe, as the JAX module under jit and eagerly.
    geom_mode: str = "auto"


# Preset table (the reference train.py augpipe_specs).
AUGPIPE_SPECS = {
    "blit": dict(xflip=1, rotate90=1, xint=1),
    "geom": dict(scale=1, rotate=1, aniso=1, xfrac=1),
    "color": dict(brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1),
    "filter": dict(imgfilter=1),
    "noise": dict(noise=1),
    "cutout": dict(cutout=1),
    "bg": dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1),
    "bgc": dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                saturation=1),
    "bgcf": dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                 xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                 saturation=1, imgfilter=1),
    "bgcfn": dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                  xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                  saturation=1, imgfilter=1, noise=1),
    "bgcfnc": dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                   xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                   saturation=1, imgfilter=1, noise=1, cutout=1),
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def make_config(spec: str, compute_dtype: Optional[str] = None) -> AugmentConfig:
    return AugmentConfig(**AUGPIPE_SPECS[spec], compute_dtype=compute_dtype)


# ----------------------------------------------------------------------------
# Homogeneous matrix helpers, batched over the leading dims; entries are
# tensors (broadcast to ``batch_shape``) or Python scalars.


def _bmat(batch_shape, device, *rows) -> torch.Tensor:
    out_rows = []
    for row in rows:
        elems = [torch.as_tensor(x, dtype=torch.float32, device=device)
                 .expand(batch_shape) for x in row]
        out_rows.append(torch.stack(elems, dim=-1))
    return torch.stack(out_rows, dim=-2)


def translate2d(tx, ty, batch_shape=(), device="cpu"):
    return _bmat(batch_shape, device, [1, 0, tx], [0, 1, ty], [0, 0, 1])


def scale2d(sx, sy, batch_shape=(), device="cpu"):
    return _bmat(batch_shape, device, [sx, 0, 0], [0, sy, 0], [0, 0, 1])


def rotate2d(theta, batch_shape=(), device="cpu"):
    c, s = torch.cos(theta), torch.sin(theta)
    return _bmat(batch_shape, device, [c, -s, 0], [s, c, 0], [0, 0, 1])


def translate3d(tx, ty, tz, batch_shape=(), device="cpu"):
    return _bmat(batch_shape, device, [1, 0, 0, tx], [0, 1, 0, ty],
                 [0, 0, 1, tz], [0, 0, 0, 1])


def scale3d(sx, sy, sz, batch_shape=(), device="cpu"):
    return _bmat(batch_shape, device, [sx, 0, 0, 0], [0, sy, 0, 0],
                 [0, 0, sz, 0], [0, 0, 0, 1])


def rotate3d(v, theta, batch_shape=(), device="cpu"):
    vx, vy, vz = v[:3]
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    return _bmat(
        batch_shape, device,
        [vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s, 0],
        [vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s, 0],
        [vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c, 0],
        [0, 0, 0, 1])


def translate2d_inv(tx, ty, batch_shape=(), device="cpu"):
    return translate2d(-tx, -ty, batch_shape, device)


def scale2d_inv(sx, sy, batch_shape=(), device="cpu"):
    return scale2d(1 / sx, 1 / sy, batch_shape, device)


def rotate2d_inv(theta, batch_shape=(), device="cpu"):
    return rotate2d(-theta, batch_shape, device)


# ----------------------------------------------------------------------------
# Bilinear resample matching torch affine_grid(align_corners=False) +
# grid_sample(bilinear, zeros padding), as four gathers.


def affine_grid_sample(images: torch.Tensor, theta: torch.Tensor,
                       out_h: int, out_w: int) -> torch.Tensor:
    n, c, in_h, in_w = images.shape
    dev = images.device
    ys = (2.0 * torch.arange(out_h, device=dev) + 1.0) / out_h - 1.0
    xs = (2.0 * torch.arange(out_w, device=dev) + 1.0) / out_w - 1.0
    gx = xs[None, None, :]
    gy = ys[None, :, None]
    t = theta[:, :, :, None, None]
    sx = t[:, 0, 0] * gx + t[:, 0, 1] * gy + t[:, 0, 2]
    sy = t[:, 1, 0] * gx + t[:, 1, 1] * gy + t[:, 1, 2]
    # Normalized -> input pixel coordinates (align_corners=False).
    ix = (sx + 1.0) * (in_w / 2.0) - 0.5
    iy = (sy + 1.0) * (in_h / 2.0) - 0.5
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = ix - x0
    wy = iy - y0
    flat = images.reshape(n, c, in_h * in_w)

    def gather(yy, xx):
        valid = (xx >= 0) & (xx < in_w) & (yy >= 0) & (yy < in_h)
        xc = torch.clamp(xx, 0, in_w - 1).long()
        yc = torch.clamp(yy, 0, in_h - 1).long()
        idx = (yc * in_w + xc).reshape(n, 1, -1).expand(n, c, out_h * out_w)
        vals = torch.gather(flat, 2, idx).reshape(n, c, out_h, out_w)
        return vals * valid[:, None].to(images.dtype)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    wx = wx[:, None].to(images.dtype)
    wy = wy[:, None].to(images.dtype)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


# ----------------------------------------------------------------------------


def _filter_bank() -> np.ndarray:
    """4-band wavelet filter bank."""
    import scipy.signal

    hz_lo = np.asarray(WAVELETS["sym2"])
    hz_hi = hz_lo * ((-1) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    fbank = np.eye(4, 1)
    for i in range(1, fbank.shape[0]):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(
            fbank.shape[0], -1)[:, :-1]
        fbank = scipy.signal.convolve(fbank, [hz_lo2])
        fbank[i, (fbank.shape[1] - hz_hi2.size) // 2:
              (fbank.shape[1] + hz_hi2.size) // 2] += hz_hi2
    return fbank


_HZ_GEOM_TAPS = WAVELETS["sym6"]


def augment_pipe(cfg: AugmentConfig, images: torch.Tensor, p, key,
                 debug_percentile: Optional[float] = None) -> torch.Tensor:
    """Apply the ADA pipe to images [N, C, H, W] with overall probability
    ``p``; ``key`` is an :class:`~gagan_tpu_torch.utils.rng.Rng` (or any
    object with its methods).  Differentiable in ``images`` to any order."""
    if cfg.geom_mode not in ("auto", "exact", "fast"):
        raise ValueError(f"geom_mode {cfg.geom_mode!r}: auto, exact or fast")
    batch, channels, height, width = images.shape
    dev = images.device
    in_dtype = images.dtype
    if cfg.compute_dtype is not None:
        images = images.to(_DTYPES[cfg.compute_dtype])
    p = torch.as_tensor(p, dtype=torch.float32, device=dev)
    dp = debug_percentile
    keys = itertools.chain(key.split(32), key.fold_in(32).split(32))
    b = (batch,)

    def rand(shape):
        return next(keys).uniform(shape, device=dev)

    def randn(shape):
        return next(keys).normal(shape, device=dev)

    def full(shape, value):
        return torch.full(shape, float(value), device=dev)

    def erfinv(v):
        return float(torch.erfinv(torch.tensor(v, dtype=torch.float32)))

    # ----- Pixel blitting + geometric: accumulate inverse 3x3 -----
    g_inv = torch.eye(3, device=dev)[None].repeat(batch, 1, 1)
    geometric = False

    if cfg.xflip > 0:
        geometric = True
        i = torch.floor(rand(b) * 2)
        i = torch.where(rand(b) < cfg.xflip * p, i, 0.0)
        if dp is not None:
            i = full(b, np.floor(dp * 2))
        g_inv = g_inv @ scale2d_inv(1 - 2 * i, torch.ones(b, device=dev), b, dev)

    if cfg.rotate90 > 0:
        geometric = True
        i = torch.floor(rand(b) * 4)
        i = torch.where(rand(b) < cfg.rotate90 * p, i, 0.0)
        if dp is not None:
            i = full(b, np.floor(dp * 4))
        g_inv = g_inv @ rotate2d_inv(-np.pi / 2 * i, b, dev)

    if cfg.xint > 0:
        geometric = True
        t = (rand((batch, 2)) * 2 - 1) * cfg.xint_max
        t = torch.where(rand((batch, 1)) < cfg.xint * p, t, 0.0)
        if dp is not None:
            t = full((batch, 2), (dp * 2 - 1) * cfg.xint_max)
        g_inv = g_inv @ translate2d_inv(torch.round(t[:, 0] * width),
                                        torch.round(t[:, 1] * height), b, dev)

    if cfg.scale > 0:
        geometric = True
        s = torch.exp2(randn(b) * cfg.scale_std)
        s = torch.where(rand(b) < cfg.scale * p, s, 1.0)
        if dp is not None:
            s = full(b, 2.0 ** (erfinv(dp * 2 - 1) * cfg.scale_std))
        g_inv = g_inv @ scale2d_inv(s, s, b, dev)

    # P(pre OR post rotation) = rotate * p.
    p_rot = 1 - torch.sqrt(torch.clamp(1 - cfg.rotate * p, 0, 1))
    if cfg.rotate > 0:
        geometric = True
        theta = (rand(b) * 2 - 1) * np.pi * cfg.rotate_max
        theta = torch.where(rand(b) < p_rot, theta, 0.0)
        if dp is not None:
            theta = full(b, (dp * 2 - 1) * np.pi * cfg.rotate_max)
        g_inv = g_inv @ rotate2d_inv(-theta, b, dev)

    if cfg.aniso > 0:
        geometric = True
        s = torch.exp2(randn(b) * cfg.aniso_std)
        s = torch.where(rand(b) < cfg.aniso * p, s, 1.0)
        if dp is not None:
            s = full(b, 2.0 ** (erfinv(dp * 2 - 1) * cfg.aniso_std))
        g_inv = g_inv @ scale2d_inv(s, 1 / s, b, dev)

    if cfg.rotate > 0:
        theta = (rand(b) * 2 - 1) * np.pi * cfg.rotate_max
        theta = torch.where(rand(b) < p_rot, theta, 0.0)
        if dp is not None:
            theta = torch.zeros(b, device=dev)
        g_inv = g_inv @ rotate2d_inv(-theta, b, dev)

    if cfg.xfrac > 0:
        geometric = True
        t = randn((batch, 2)) * cfg.xfrac_std
        t = torch.where(rand((batch, 1)) < cfg.xfrac * p, t, 0.0)
        if dp is not None:
            t = full((batch, 2), erfinv(dp * 2 - 1) * cfg.xfrac_std)
        g_inv = g_inv @ translate2d_inv(t[:, 0] * width, t[:, 1] * height,
                                        b, dev)

    # ----- Execute geometric transformations -----
    if geometric and cfg.geom_mode == "fast":
        # The native-resolution warp behind a static reflect margin: zeros
        # where an extreme draw reaches past it (the exact branch reflects
        # by a data-dependent margin instead).
        sx = min(width // cfg.jit_margin_divisor, width - 1)
        sy = min(height // cfg.jit_margin_divisor, height - 1)
        images = F.pad(images, (sx, sx, sy, sy), mode="reflect")
        g_n = (scale2d(2 / images.shape[3], 2 / images.shape[2], (), dev)
               @ g_inv @ scale2d_inv(2 / width, 2 / height, (), dev))
        images = affine_warp(images, g_n[:, :2, :], height, width,
                             antialias=True)
    elif geometric:
        hz_geom = setup_filter(_HZ_GEOM_TAPS, device=dev)
        cx = (width - 1) / 2
        cy = (height - 1) / 2
        cp = torch.tensor([[-cx, -cy, 1], [cx, -cy, 1], [cx, cy, 1],
                           [-cx, cy, 1]], dtype=torch.float32, device=dev)
        cp = g_inv @ cp.T                                     # [N, xyz, idx]
        hz_pad = len(_HZ_GEOM_TAPS) // 4
        margin = cp[:, :2, :].permute(1, 0, 2).reshape(2, -1)
        margin = torch.cat([-margin, margin], dim=1).amax(dim=1)
        margin = torch.cat([margin, margin])                  # [x0, y0, x1, y1]
        margin = margin + torch.tensor([hz_pad * 2 - cx, hz_pad * 2 - cy] * 2,
                                       device=dev)
        margin = torch.clamp(margin, min=0)
        margin = torch.minimum(margin, torch.tensor(
            [width - 1, height - 1] * 2, dtype=torch.float32, device=dev))
        shard = getattr(key, "shard", None)
        if shard is not None:
            # A rank's share of a data-parallel batch (the key is a
            # parallel.mesh.ShardedRng): the margin is the global batch's.
            mesh = shard.mesh
            margin = mesh.gather(margin[None], [mesh.rank],
                                 mesh.world_size).amax(dim=0)
        # The data-dependent margin becomes the pad width: one host read.
        with trace_scope("host_read.margin"):
            margin = margin.cpu().numpy()
        mx0, my0, mx1, my1 = (int(v) for v in np.ceil(margin))
        images = F.pad(images, (mx0, mx1, my0, my1), mode="reflect")
        g_inv = translate2d((mx0 - mx1) / 2, (my0 - my1) / 2, (), dev) @ g_inv

        images = upsample2d(images, hz_geom, up=2)
        g_inv = scale2d(2, 2, (), dev) @ g_inv @ scale2d_inv(2, 2, (), dev)
        g_inv = (translate2d(-0.5, -0.5, (), dev) @ g_inv
                 @ translate2d_inv(-0.5, -0.5, (), dev))

        out_h = (height + hz_pad * 2) * 2
        out_w = (width + hz_pad * 2) * 2
        g_inv = (scale2d(2 / images.shape[3], 2 / images.shape[2], (), dev)
                 @ g_inv @ scale2d_inv(2 / out_w, 2 / out_h, (), dev))
        images = affine_grid_sample(images, g_inv[:, :2, :], out_h, out_w)
        images = downsample2d(images, hz_geom, down=2, padding=-hz_pad * 2,
                              flip_filter=True)

    # ----- Color transformations -----
    i4 = torch.eye(4, device=dev)
    c_mat = i4[None].repeat(batch, 1, 1)
    colored = False
    v = np.float32([1, 1, 1, 0]) / np.float32(np.sqrt(3))   # luma axis
    vvt = torch.outer(*[torch.from_numpy(v).to(dev)] * 2)

    if cfg.brightness > 0:
        colored = True
        bb = randn(b) * cfg.brightness_std
        bb = torch.where(rand(b) < cfg.brightness * p, bb, 0.0)
        if dp is not None:
            bb = full(b, erfinv(dp * 2 - 1) * cfg.brightness_std)
        c_mat = translate3d(bb, bb, bb, b, dev) @ c_mat

    if cfg.contrast > 0:
        colored = True
        cc = torch.exp2(randn(b) * cfg.contrast_std)
        cc = torch.where(rand(b) < cfg.contrast * p, cc, 1.0)
        if dp is not None:
            cc = full(b, 2.0 ** (erfinv(dp * 2 - 1) * cfg.contrast_std))
        c_mat = scale3d(cc, cc, cc, b, dev) @ c_mat

    if cfg.lumaflip > 0:
        colored = True
        i = torch.floor(rand((batch, 1, 1)) * 2)
        i = torch.where(rand((batch, 1, 1)) < cfg.lumaflip * p, i, 0.0)
        if dp is not None:
            i = full((batch, 1, 1), np.floor(dp * 2))
        c_mat = (i4 - 2 * vvt * i) @ c_mat

    if cfg.hue > 0 and channels > 1:
        colored = True
        theta = (rand(b) * 2 - 1) * np.pi * cfg.hue_max
        theta = torch.where(rand(b) < cfg.hue * p, theta, 0.0)
        if dp is not None:
            theta = full(b, (dp * 2 - 1) * np.pi * cfg.hue_max)
        c_mat = rotate3d([float(t) for t in v], theta, b, dev) @ c_mat

    if cfg.saturation > 0 and channels > 1:
        colored = True
        s = torch.exp2(randn((batch, 1, 1)) * cfg.saturation_std)
        s = torch.where(rand((batch, 1, 1)) < cfg.saturation * p, s, 1.0)
        if dp is not None:
            s = full((batch, 1, 1),
                     2.0 ** (erfinv(dp * 2 - 1) * cfg.saturation_std))
        c_mat = (vvt + (i4 - vvt) * s) @ c_mat

    if colored:
        c_mat = c_mat.to(images.dtype)
        flat = images.reshape(batch, channels, height * width)
        if channels == 3:
            flat = c_mat[:, :3, :3] @ flat + c_mat[:, :3, 3:]
        elif channels == 1:
            cm = c_mat[:, :3, :].mean(dim=1, keepdim=True)
            flat = flat * cm[:, :, :3].sum(dim=2, keepdim=True) + cm[:, :, 3:]
        else:
            raise ValueError("images must have 1 or 3 channels")
        images = flat.reshape(batch, channels, height, width)

    # ----- Image-space filtering -----
    if cfg.imgfilter > 0:
        fbank = torch.as_tensor(_filter_bank(), dtype=torch.float32,
                                device=dev)
        num_bands = fbank.shape[0]
        if len(cfg.imgfilter_bands) != num_bands:
            raise ValueError(f"imgfilter_bands needs {num_bands} entries")
        expected_power = torch.tensor(np.array([10, 1, 1, 1]) / 13,
                                      dtype=torch.float32, device=dev)
        g = torch.ones((batch, num_bands), device=dev)
        for i, band_strength in enumerate(cfg.imgfilter_bands):
            t_i = torch.exp2(randn(b) * cfg.imgfilter_std)
            t_i = torch.where(
                rand(b) < cfg.imgfilter * p * band_strength, t_i, 1.0)
            if dp is not None:
                t_i = (full(b, 2.0 ** (erfinv(dp * 2 - 1) * cfg.imgfilter_std))
                       if band_strength > 0 else torch.ones(b, device=dev))
            t = torch.ones((batch, num_bands), device=dev)
            t[:, i] = t_i
            t = t / torch.sqrt((expected_power * t.square()).sum(
                dim=-1, keepdim=True))
            g = g * t

        hz_prime = g @ fbank                                  # [N, taps]
        taps = hz_prime.shape[1]
        pad = fbank.shape[1] // 2
        x = images.reshape(1, batch * channels, height, width)
        x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
        w = hz_prime[:, None, :].repeat(1, channels, 1)
        w = w.reshape(batch * channels, 1, taps).to(x.dtype)
        x = F.conv2d(x, w[:, :, None, :], groups=batch * channels)
        x = F.conv2d(x, w[:, :, :, None], groups=batch * channels)
        images = x.reshape(batch, channels, height, width)

    # ----- Image-space corruptions -----
    if cfg.noise > 0:
        sigma = randn((batch, 1, 1, 1)).abs() * cfg.noise_std
        sigma = torch.where(rand((batch, 1, 1, 1)) < cfg.noise * p, sigma, 0.0)
        if dp is not None:
            sigma = full((batch, 1, 1, 1), erfinv(dp) * cfg.noise_std)
        images = images + randn((batch, channels, height, width)) * sigma

    if cfg.cutout > 0:
        size = full((batch, 2, 1, 1, 1), cfg.cutout_size)
        size = torch.where(rand((batch, 1, 1, 1, 1)) < cfg.cutout * p,
                           size, 0.0)
        center = rand((batch, 2, 1, 1, 1))
        if dp is not None:
            size = full((batch, 2, 1, 1, 1), cfg.cutout_size)
            center = full((batch, 2, 1, 1, 1), dp)
        coord_x = torch.arange(width, device=dev).reshape(1, 1, 1, -1)
        coord_y = torch.arange(height, device=dev).reshape(1, 1, -1, 1)
        mask_x = ((coord_x + 0.5) / width - center[:, 0]).abs() >= size[:, 0] / 2
        mask_y = ((coord_y + 0.5) / height - center[:, 1]).abs() >= size[:, 1] / 2
        mask = torch.logical_or(mask_x, mask_y).to(images.dtype)
        images = images * mask

    return images.to(in_dtype)


def make_augment_fn(cfg: AugmentConfig):
    """Adapter to the trainer's augment signature (img, p, key) -> img.

    This is the train step's pipe, which the JAX package jits, so "auto"
    resolves to "fast" here (a direct augment_pipe call keeps "exact")."""
    if cfg.geom_mode == "auto":
        cfg = dataclasses.replace(cfg, geom_mode="fast")

    def fn(images, p, key):
        with trace_scope("augment", device=True):
            return augment_pipe(cfg, images, p, key)

    return fn
