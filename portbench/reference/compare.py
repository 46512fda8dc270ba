"""The numbers that decide ``correct``: gaps between the program's readings
and the reference's, each taken by the worst leaf or the worst value."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Sequence


def rel_gap(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def loss_gap(prog: Sequence[Dict[str, float]],
             ref: Sequence[Dict[str, float]]) -> float:
    """The largest relative gap of a loss over the batches compared; a
    loss the program did not report, or a batch missing, reads inf."""
    if len(prog) != len(ref):
        return math.inf
    worst = 0.0
    for p, r in zip(prog, ref):
        for k, rv in r.items():
            if k not in p:
                return math.inf
            worst = max(worst, rel_gap(p[k], rv))
    return worst


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keys: Iterable[str]) -> float:
    """max over ``keys`` of |program's norm - reference's norm| over the
    larger of the reference's norm of that leaf and of the median leaf
    (some gradients are all but zero); a leaf the program lacks reads
    inf."""
    keys = list(keys)
    if not keys:
        return math.inf
    median = statistics.median(ref[k] for k in keys)
    worst = 0.0
    for k in keys:
        if k not in prog or not math.isfinite(prog[k]):
            return math.inf
        worst = max(worst, abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30))
    return worst


def tensors(keys: Iterable[str], sizes: Dict[str, int], prefix: str = ""
            ) -> List[str]:
    """The keys of leaves with more than one element.  A single number (a
    noise strength, ``pl_mean``) is a sum of many terms of either sign; its
    rounding error relative to it swings from seed to seed, far beyond any
    tensor's (PERF.md)."""
    return sorted(k for k in keys if sizes.get(k[len(prefix):]
                                               if k.startswith(prefix)
                                               else k, 1) > 1)


def moving_leaves(first_ref: Dict[str, float], change_ref: Dict[str, float],
                  floor: float = 1e-3) -> List[str]:
    """The leaves whose change is compared: those that the reference
    moves, but those whose gradient is nought to rounding in the reference
    (the root of its second moment under ``floor`` times the median
    leaf's), whose Adam step is round-off alone; G_ema follows its G
    leaf."""
    nu = {k[len("rootnu/"):]: v for k, v in first_ref.items()
          if k.startswith("rootnu/")}
    quiet = set()
    if nu:
        median = statistics.median(nu.values())
        quiet = {k for k, v in nu.items() if v < floor * median}
        quiet |= {"E/" + k[2:] for k in quiet if k.startswith("G/")}
    return sorted(k for k, v in change_ref.items()
                  if v > 0 and k not in quiet)


MAIN_LOSSES = ("Loss/G/loss", "Loss/D/loss")
REG_LOSSES = ("Loss/G/reg", "Loss/D/reg")


def train_checks(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of a training cell, by the reference's tensor leaves
    (``tensors``): the first step's losses but the lazy regularizers', D's
    per-sample outputs in the first step (``logit_gap``, where the
    reference records them), the first step's gradients as Adam holds them
    (the worst leaf), and each leaf's change after the last step (the worst
    leaf, and the median leaf).  Not compared (PERF.md gives the readings): the later steps'
    losses, which Adam's first sign-like steps make swing by per cent on
    any precision, and the path-length and R1 penalties, whose reduced
    precision reading the control does not separate."""
    sizes = ref["sizes"]
    first = {k: v for k, v in ref["losses"][0].items()
             if k not in REG_LOSSES}
    grads = [leaf_gap(prog["first"], ref["first"], tensors(
        (k for k in ref["first"] if k.startswith(m)), sizes, m))
        for m in ("mu/", "rootnu/")]
    moving = tensors(moving_leaves(ref["first"], ref["change"]), sizes)
    out = {
        "loss_gap": loss_gap(prog["losses"][:1], [first]),
        "grad_gap": max(grads),
        "change_gap": leaf_gap(prog["change"], ref["change"], moving),
        "change_median_gap": median_leaf_gap(prog["change"], ref["change"],
                                             moving),
    }
    if "logits" in ref:
        out["logit_gap"] = logit_gap(prog.get("logits", []), ref["logits"])
    return out


def logit_gap(prog: Sequence, ref: Sequence) -> float:
    """D's per-sample outputs in the first step, call by call: the largest
    difference of a sample's logit over the RMS of the reference's logits
    of that call; a call or a sample the program lacks reads inf."""
    if len(prog) != len(ref):
        return math.inf
    worst = 0.0
    for p, r in zip(prog, ref):
        if tuple(p.shape) != tuple(r.shape):
            return math.inf
        scale = max(float(r.float().square().mean().sqrt()), 1e-6)
        worst = max(worst, float((p.float() - r.float()).abs().max()) / scale)
    return worst


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    keys: Iterable[str]) -> float:
    """The median over ``keys`` of each leaf's gap as ``leaf_gap`` takes
    it: steady from seed to seed where single leaves are not."""
    keys = list(keys)
    if not keys or any(k not in prog or not math.isfinite(prog[k])
                       for k in keys):
        return math.inf
    median = statistics.median(ref[k] for k in keys)
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], median,
                                                         1e-30)
                             for k in keys)


def judged(readings: Dict[str, float], limits: Dict[str, float]):
    """The readings that the cell compares (those its mix gives a limit)."""
    return {k: v for k, v in readings.items() if k in limits}


def image_checks(prog_u8, ref_u8) -> Dict[str, float]:
    """The program's uint8 images [N, H, W, C] against the reference's, in
    levels of 255: the worst image's RMS difference, and the worst image's
    mean difference (its colour cast)."""
    d = prog_u8.float() - ref_u8.float()
    return {"image_rms_levels": float(d.square().mean(dim=(1, 2, 3))
                                      .sqrt().max()),
            "image_mean_levels": float(d.mean(dim=(1, 2)).abs().max())}


def adapt_checks(prog: Dict, ref: Dict) -> Dict[str, float]:
    """A one-shot adaptation cell's numbers: the training numbers, and the
    first step's trainable images as ``image_checks`` takes them (the
    generator inside the step: the CLIP tower's configured bf16, which
    the control shares, sets the floor of the others)."""
    return {**train_checks(prog, ref),
            **image_checks(prog["images"], ref["images"])}

