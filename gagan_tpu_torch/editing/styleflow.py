"""StyleFlow: a conditional continuous normalizing flow over W+ latents
(port of gagan_tpu/editing/styleflow.py).

The ConcatSquash ODE net with tanh between its layers, MovingBatchNorm at
inference (running statistics and the affine y * exp(weight) + bias, eps
1e-4, both directions), the bn / cnf / bn chain, and the attribute editor.
The ODE integrates from 0 to sqrt_end_time^2 (reversed for ``reverse``)
with the JAX module's solvers: "dopri5", Dormand-Prince 5(4) with the
Hairer initial step, a controller of safety 0.9 and growth clamped to
[0.2, 10], the last step clamped onto the end, and at most ``max_steps``
steps, after which it stops where it is, silently, as the JAX loop does;
or "rk4" on a fixed grid.  The adaptive loop tests its end on the host:
one read of a device scalar per step, counted in ``DOPRI5_STATS``.  The
divergence state is dropped, since it never feeds back into dy/dt.

The flow integrates in float32 with TF32 matmuls off (the solver's
tolerances, 1e-5, are finer than TF32's rounding).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class StyleFlowConfig:
    input_dim: int = 512
    hidden_dims: Tuple[int, ...] = (512, 512, 512, 512, 512)
    context_dim: int = 17              # 9 lighting + 8 attributes
    num_blocks: int = 1
    solver: str = "dopri5"             # or "rk4"
    rk4_steps: int = 40
    atol: float = 1e-5
    rtol: float = 1e-5
    max_steps: int = 1000              # the adaptive solver's step bound


# Steps and host reads of the adaptive solver since the last reset.
DOPRI5_STATS = {"steps": 0, "host_reads": 0}


@contextlib.contextmanager
def _fp32_matmuls():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _concat_squash(p: Params, context: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """layer(x) * sigmoid(gate(context)) + bias(context)."""
    gate = torch.sigmoid(context @ p["_hyper_gate"]["weight"].t()
                         + p["_hyper_gate"]["bias"])
    bias = context @ p["_hyper_bias"]["weight"].t()
    y = x @ p["_layer"]["weight"].t() + p["_layer"]["bias"]
    if x.ndim == 3:
        gate, bias = gate[:, None], bias[:, None]
    return y * gate + bias


def _odenet(p: Params, cfg: StyleFlowConfig, t: torch.Tensor,
            context: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dx/dt: the ConcatSquash layers over [t ; context], tanh between."""
    n = x.shape[0]
    tc = torch.cat([t.reshape(1, 1).expand(n, 1).to(x.dtype),
                    context.reshape(n, -1)], dim=1)
    dx = x
    n_layers = len(cfg.hidden_dims) + 1
    for i in range(n_layers):
        dx = _concat_squash(p["layers"][str(i)], tc, dx)
        if i < n_layers - 1:
            dx = torch.tanh(dx)
    return dx


def _moving_bn(p: Params, x: torch.Tensor, reverse: bool,
               eps: float = 1e-4) -> torch.Tensor:
    mean, var = p["running_mean"], p["running_var"]
    weight, bias = p.get("weight"), p.get("bias")
    if not reverse:
        y = (x - mean) * torch.rsqrt(var + eps)
        if weight is not None:
            y = y * torch.exp(weight) + bias
        return y
    if weight is not None:
        x = (x - bias) * torch.exp(-weight)
    return x * torch.sqrt(var + eps) + mean


# Dormand-Prince 5(4) tableau.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x.square().mean().sqrt()


def _dopri5(f, y0: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
            rtol: float, atol: float, max_steps: int) -> torch.Tensor:
    """y(t1) of y' = f(t, y), y(t0) = y0, either direction; t, h and the
    error norm are float32 device scalars, as in the JAX loop."""
    direction = torch.sign(t1 - t0)
    span = (t1 - t0).abs()

    f0 = f(t0, y0)
    scale = atol + rtol * y0.abs()
    d0, d1 = _rms(y0 / scale), _rms(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    f1 = f(t0 + h0 * direction, y0 + h0 * direction * f0)
    d2 = _rms((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp_min(h0 * 1e-3, 1e-6),
                     (0.01 / dmax) ** 0.2)
    h = torch.minimum(torch.minimum(100 * h0, h1), span)

    t, y, steps = t0.clone(), y0, 0
    while steps < max_steps:
        DOPRI5_STATS["host_reads"] += 1
        if not bool((t - t0).abs() < span):
            break
        h = torch.minimum(h, span - (t - t0).abs())
        hs = h * direction
        ks = []
        for i in range(7):
            yi = y
            for j, a in enumerate(_DP_A[i]):
                if a != 0.0:
                    yi = yi + hs * a * ks[j]
            ks.append(f(t + _DP_C[i] * hs, yi))
        y5, y4 = y, y
        for b, k in zip(_DP_B5, ks):
            if b != 0.0:
                y5 = y5 + hs * b * k
        for b, k in zip(_DP_B4, ks):
            if b != 0.0:
                y4 = y4 + hs * b * k
        err = _rms((y5 - y4) / (atol + rtol * torch.maximum(y.abs(),
                                                           y5.abs())))
        accept = err <= 1.0
        factor = torch.clamp(0.9 * torch.clamp_min(err, 1e-10) ** -0.2,
                             0.2, 10.0)
        h = torch.clamp_min(h * factor, 1e-8)
        t = torch.where(accept, t + hs, t)
        y = torch.where(accept, y5, y)
        steps += 1
    DOPRI5_STATS["steps"] += steps
    return y


def _cnf_integrate(p: Params, cfg: StyleFlowConfig, x: torch.Tensor,
                   context: torch.Tensor, reverse: bool) -> torch.Tensor:
    T = p["sqrt_end_time"].square().reshape(())
    zero = torch.zeros_like(T)

    def f(t, y):
        return _odenet(p["odefunc"]["diffeq"], cfg, t, context, y)

    t0 = T if reverse else zero
    if cfg.solver == "dopri5":
        return _dopri5(f, x, t0, zero if reverse else T, cfg.rtol, cfg.atol,
                       cfg.max_steps)
    h = T / cfg.rk4_steps * (-1.0 if reverse else 1.0)
    y, t = x, t0
    for _ in range(cfg.rk4_steps):
        k1 = f(t, y)
        k2 = f(t + h / 2, y + h / 2 * k1)
        k3 = f(t + h / 2, y + h / 2 * k2)
        k4 = f(t + h, y + h * k3)
        y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        t = t + h
    return y


def flow_apply(params: Params, cfg: StyleFlowConfig, x: torch.Tensor,
               context: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The chain bn0, cnf0, bn1, ...; reversed, each link inverted, for
    ``reverse``."""
    chain: List[Tuple[str, str]] = [("bn", "0")]
    for b in range(cfg.num_blocks):
        chain += [("cnf", str(b)), ("bn", str(b + 1))]
    if reverse:
        chain = chain[::-1]
    with _fp32_matmuls():
        for kind, idx in chain:
            if kind == "bn":
                x = _moving_bn(params["bn"][idx], x, reverse)
            else:
                x = _cnf_integrate(params["cnf"][idx], cfg, x, context,
                                   reverse)
    return x


def init_styleflow(rng, cfg: StyleFlowConfig, device="cpu") -> Params:
    """Random weights N(0, 0.01^2) and zero biases, layer ``i`` of block
    ``b`` from ``rng.fold_in(100 * b + i)`` (its linear, hyper-bias and
    hyper-gate from ``.fold_in(0 / 1 / 2)``); sqrt_end_time 1 and the batch
    norms at identity, as the JAX init makes them."""
    def lin(r, n_in, n_out, bias=True):
        p = {"weight": (r.normal((n_out, n_in), device) * 0.01).to(device)}
        if bias:
            p["bias"] = torch.zeros((n_out,), device=device)
        return p

    dims = (cfg.input_dim,) + tuple(cfg.hidden_dims) + (cfg.input_dim,)
    cnf_blocks = {}
    for b in range(cfg.num_blocks):
        layers = {}
        for i in range(len(dims) - 1):
            r = rng.fold_in(b * 100 + i)
            layers[str(i)] = {
                "_layer": lin(r.fold_in(0), dims[i], dims[i + 1]),
                "_hyper_bias": lin(r.fold_in(1), 1 + cfg.context_dim,
                                   dims[i + 1], bias=False),
                "_hyper_gate": lin(r.fold_in(2), 1 + cfg.context_dim,
                                   dims[i + 1])}
        cnf_blocks[str(b)] = {"odefunc": {"diffeq": {"layers": layers}},
                              "sqrt_end_time": torch.ones((), device=device)}
    d = cfg.input_dim
    bns = {str(i): {"running_mean": torch.zeros((d,), device=device),
                    "running_var": torch.ones((d,), device=device),
                    "weight": torch.zeros((d,), device=device),
                    "bias": torch.zeros((d,), device=device)}
           for i in range(cfg.num_blocks + 1)}
    return {"cnf": cnf_blocks, "bn": bns}


def torch_state_to_tree(state_dict, cfg: StyleFlowConfig,
                        device="cpu") -> Params:
    """A reference StyleFlow state dict (the SequentialFlow chain bn0,
    cnf0, bn1, ...; tensors or arrays) -> this module's tree on
    ``device``."""
    sd = {k: torch.as_tensor(np.asarray(v.detach().cpu() if
                                        isinstance(v, torch.Tensor) else v))
          for k, v in state_dict.items()}
    n_layers = len(cfg.hidden_dims) + 1

    def bn_tree(chain_idx):
        prefix = f"chain.{chain_idx}."
        out = {"running_mean": sd[prefix + "running_mean"],
               "running_var": sd[prefix + "running_var"]}
        if prefix + "weight" in sd:
            out["weight"] = sd[prefix + "weight"]
            out["bias"] = sd[prefix + "bias"]
        return out

    def cnf_tree(chain_idx):
        prefix = f"chain.{chain_idx}."
        layers = {}
        for i in range(n_layers):
            lp = prefix + f"odefunc.diffeq.layers.{i}."
            layers[str(i)] = {
                "_layer": {"weight": sd[lp + "_layer.weight"],
                           "bias": sd[lp + "_layer.bias"]},
                "_hyper_bias": {"weight": sd[lp + "_hyper_bias.weight"]},
                "_hyper_gate": {"weight": sd[lp + "_hyper_gate.weight"],
                                "bias": sd[lp + "_hyper_gate.bias"]}}
        return {"odefunc": {"diffeq": {"layers": layers}},
                "sqrt_end_time": sd[prefix + "sqrt_end_time"].reshape(())}

    tree = {"cnf": {str(b): cnf_tree(2 * b + 1)
                    for b in range(cfg.num_blocks)},
            "bn": {str(b): bn_tree(2 * b) for b in range(cfg.num_blocks + 1)}}

    def to(node):
        return ({k: to(v) for k, v in node.items()} if isinstance(node, dict)
                else node.to(device))

    return to(tree)


# ----------------------------------------------------------------------------
# The attribute editor

ATTR_ORDER = ["Gender", "Glasses", "Yaw", "Pitch", "Baldness", "Beard",
              "Age", "Expression"]
LIGHTING_ORDER = ["Left->Right", "Right->Left", "Down->Up", "Up->Down",
                  "No light", "Front light"]
ATTR_DEGREE = [1.5, 2.5, 1.0, 1.0, 2.0, 1.7, 0.93, 1.0]
MIN_VAL = {"Gender": 0, "Glasses": 0, "Yaw": -20, "Pitch": -20,
           "Baldness": 0, "Beard": 0.0, "Age": 0, "Expression": 0}
MAX_VAL = {"Gender": 1, "Glasses": 1, "Yaw": 20, "Pitch": 20,
           "Baldness": 1, "Beard": 1, "Age": 65, "Expression": 1}

# Per attribute, the (start, end) ranges of w layers kept from the original.
_PRESERVE = {
    0: [(8, None)],
    1: [(0, 2), (4, None)],
    2: [(4, None)],
    3: [(4, None)],
    4: [(6, None)],
    5: [(0, 5), (10, None)],
    6: [(0, 4), (8, None)],
    7: [(0, 4), (6, None)],
}


class StyleFlowEditor:
    """Edit one attribute of a W+ latent through the flow: forward at the
    current attributes, reverse at the edited ones, and the layers that
    attribute does not own copied back."""

    def __init__(self, params: Params, cfg: StyleFlowConfig,
                 num_ws: int = 18):
        self.params = params
        self.cfg = cfg
        self.num_ws = num_ws

    def _context(self, lighting, attributes, device) -> torch.Tensor:
        ctx = np.concatenate([np.asarray(lighting, np.float32).reshape(1, -1),
                              np.asarray(attributes, np.float32).reshape(1, -1)],
                             axis=1)
        return torch.from_numpy(np.tile(ctx, (self.num_ws, 1))).to(device)

    @torch.no_grad()
    def edit(self, w_plus: torch.Tensor, attributes: np.ndarray,
             lighting: np.ndarray, attr_idx: int,
             edit_power: float) -> torch.Tensor:
        """w_plus [1, num_ws, 512]; attributes [8]; lighting [9]."""
        device = w_plus.device
        x = w_plus.reshape(self.num_ws, -1) if w_plus.ndim == 3 else w_plus
        z = flow_apply(self.params, self.cfg, x,
                       self._context(lighting, attributes, device))
        name = ATTR_ORDER[attr_idx]
        real_value = (edit_power * (MAX_VAL[name] - MIN_VAL[name])
                      + MIN_VAL[name])
        change = real_value - float(attributes[attr_idx])
        new_attrs = np.asarray(attributes, np.float32).copy()
        new_attrs[attr_idx] = (ATTR_DEGREE[attr_idx] * change
                               + float(attributes[attr_idx]))
        edited = flow_apply(self.params, self.cfg, z,
                            self._context(lighting, new_attrs, device),
                            reverse=True).reshape(1, self.num_ws, -1)
        orig = w_plus.reshape(1, self.num_ws, -1)
        for start, end in _PRESERVE[attr_idx]:
            end = self.num_ws if end is None else end
            edited[:, start:end] = orig[:, start:end]
        return edited
