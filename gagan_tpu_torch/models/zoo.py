"""Generator registry and the uniform shift API (port of
gagan_tpu/models/zoo.py): a name -> maker registry over the generator
families (stylegan2, biggan, proggan, sn_anime, sn_mnist), each maker
giving a :class:`GeneratorHandle` with ``forward(z)`` and
``gen_shifted(z, shift)``.

Every maker takes ``device`` (CUDA unless the caller asks for the CPU) and
an npz of flat weights (the JAX tree's dotted keys), or a weight tree as
``params``, or, with neither, random weights drawn from ``torch.Generator``
seed 0 (which are not the JAX package's ``PRNGKey(0)`` weights).  The forwards build no autograd graph of
their own weights, so a caller can differentiate through ``gen_shifted``
with respect to a shift that requires grad.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..utils import checkpoint as ckpt_lib

generator_registry: Dict[str, Callable] = {}


def register_generator(name):
    def deco(fn):
        generator_registry[name] = fn
        return fn
    return deco


@dataclasses.dataclass
class GeneratorHandle:
    """Uniform wrapper: ``forward(z)`` and ``gen_shifted(z, shift)``."""

    forward: Callable[[torch.Tensor], torch.Tensor]
    dim_z: int
    dim_shift: int
    gen_shifted: Optional[Callable[[torch.Tensor, torch.Tensor],
                                   torch.Tensor]] = None

    def __post_init__(self):
        if self.gen_shifted is None:
            # A shift in z.
            self.gen_shifted = lambda z, shift: self.forward(z + shift)


def _weights(weights_path: Optional[str], params: Optional[Dict], device,
             init: Callable[[], Dict]) -> Dict:
    """The npz at ``weights_path``, else ``params``, else ``init()``, on
    ``device``."""
    if weights_path:
        with np.load(weights_path, allow_pickle=False) as data:
            return ckpt_lib.flat_to_tree({k: data[k] for k in data.files},
                                         device)
    return ckpt_lib.tree_to_device(init() if params is None else params,
                                   device)


@register_generator("stylegan2")
def make_stylegan2(snapshot_path: str, shift_in_w: bool = True,
                   truncation: float = 1.0, device="cuda") -> GeneratorHandle:
    """A StyleGAN2 snapshot's generator, shifted in w (or in z)."""
    from ..cli.generate import load_generator
    from . import stylegan2 as sg2

    device = resolve_device(device)
    g_cfg, params = load_generator(snapshot_path, device)

    def forward(z):
        return sg2.generator_apply(g_cfg, params, z.to(device),
                                   truncation_psi=truncation)

    def forward_w(w):
        ws = w[:, None, :].expand(-1, g_cfg.num_ws, -1)
        return sg2.synthesis_apply(g_cfg.synthesis, params["synthesis"], ws)

    def style(z):
        return sg2.mapping_apply(g_cfg.mapping, params["mapping"],
                                 z.to(device), broadcast=False)

    if shift_in_w:
        def gen_shifted(z, shift):
            return forward_w(style(z) + shift)
    else:
        def gen_shifted(z, shift):
            return forward(z + shift)

    return GeneratorHandle(forward=forward, dim_z=g_cfg.z_dim,
                           dim_shift=g_cfg.w_dim if shift_in_w else g_cfg.z_dim,
                           gen_shifted=gen_shifted)


@register_generator("biggan")
def make_biggan(weights_path: Optional[str] = None, target_classes=(239,),
                device="cuda", params: Optional[Dict] = None,
                **cfg_kwargs) -> GeneratorHandle:
    """BigGAN conditioned on ``target_classes``: without explicit class ids
    each call draws the batch's classes from them with
    ``np.random.RandomState(i)``, i counting the calls, as the JAX maker
    does (the same classes in both packages)."""
    from . import biggan as bg

    device = resolve_device(device)
    cfg = bg.BigGANConfig(**cfg_kwargs)
    params = _weights(weights_path, params, device, lambda: bg.init_biggan(
        torch.Generator().manual_seed(0), cfg))
    classes = np.asarray(target_classes)
    calls = {"i": 0}

    def mixed_classes(batch):
        rnd = np.random.RandomState(calls["i"])
        calls["i"] += 1
        return torch.as_tensor(rnd.choice(classes, batch), device=device)

    def forward(z, class_ids=None):
        c = (mixed_classes(z.shape[0]) if class_ids is None
             else torch.as_tensor(np.asarray(class_ids), device=device))
        return bg.biggan_apply(cfg, params, z.to(device), c)

    return GeneratorHandle(forward=forward, dim_z=cfg.dim_z,
                           dim_shift=cfg.dim_z)


@register_generator("proggan")
def make_proggan(weights_path: Optional[str] = None, device="cuda",
                 params: Optional[Dict] = None) -> GeneratorHandle:
    from . import proggan as pg

    device = resolve_device(device)
    params = _weights(weights_path, params, device, lambda: pg.init_proggan(
        torch.Generator().manual_seed(0)))
    return GeneratorHandle(
        forward=lambda z: pg.proggan_apply(params, z.to(device)),
        dim_z=pg.Z_DIM, dim_shift=pg.Z_DIM)


def _make_sngan(arch: str, weights_path: Optional[str], device,
                params: Optional[Dict]) -> GeneratorHandle:
    from . import sngan as sn

    device = resolve_device(device)
    cfg = sn.SNGANConfig(arch=arch)
    params = _weights(weights_path, params, device, lambda: sn.init_sngan(
        torch.Generator().manual_seed(0), cfg))
    return GeneratorHandle(
        forward=lambda z: sn.sngan_apply(cfg, params, z.to(device)),
        dim_z=cfg.dim_z, dim_shift=cfg.dim_z)


@register_generator("sn_anime")
def make_sn_anime(weights_path: Optional[str] = None, device="cuda",
                  params: Optional[Dict] = None) -> GeneratorHandle:
    return _make_sngan("sn_resnet128", weights_path, device, params)


@register_generator("sn_mnist")
def make_sn_mnist(weights_path: Optional[str] = None, device="cuda",
                  params: Optional[Dict] = None) -> GeneratorHandle:
    return _make_sngan("sn_resnet32", weights_path, device, params)


def make_generator(name: str, **kwargs) -> GeneratorHandle:
    return generator_registry[name](**kwargs)
