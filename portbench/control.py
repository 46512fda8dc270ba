"""The control of a cell's correctness check, and its planted faults: the
plain reference put in the program's place, against the float32
reference, at the cell's own sizes.

* By default, the control: the reference one precision below the
  configuration's (``reference/train_ref.py::PRECISIONS``): its float32
  blocks and linear layers in bf16, its bf16 blocks' convolutions and the
  CLIP tower's linear layers on fp8 operands.
* ``--fault half_batch|altered`` (float32): half of each batch left out,
  the mean taken over the rest; or an answer altered where it is
  produced: the first sample of every G output (generation, and the
  adaptation step's trainable images) by 0.25, 32 levels; in a training
  step, the first sample's D logit by 1.  A step that returns
  its state unchanged reads 1 by the training cells' measure and needs no
  run.

Its readings are the upper ends that the cell's limits were set below;
the benchmark's runs never run it.  Each seed's readings are judged as a
run's are, under the cell's own limits (``reference/compare.py::judged``,
``harness.Check``): a control or a fault that the check catches comes
out ``correct: false``, with the numbers that failed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--fault F]

Prints one JSON line a seed: {"workload", "seed", "control", "readings",
"correct", "failed"}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def first_only(t, value: float):
    """``value`` on the first sample of ``t``, zero elsewhere."""
    import torch

    bump = torch.zeros_like(t)
    bump[0] = value
    return bump


@contextlib.contextmanager
def planted(fault: str):
    """The fault planted in the frozen reference for the length of the
    block."""
    import torch

    from portbench.reference.frozen.models import stylegan2 as sg2
    from portbench.reference.frozen.train import adaptation as ad
    from portbench.reference.frozen.train import gan_loss

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "half_batch":
        main = gan_loss.gd_main_loss

        def half_main(cfg, g_cfg, d_cfg, g_params, d_params, real_img, z,
                      key, **kw):
            n = z.shape[0] // 2
            return main(cfg, g_cfg, d_cfg, g_params, d_params, real_img[:n],
                        z[:n], key, **kw)
        patch(gan_loss, "gd_main_loss", half_main)
        gen = sg2.generator_apply

        def half_gen(*a, **k):
            img = gen(*a, **k)
            img[img.shape[0] // 2:] = 0
            return img
        patch(sg2, "generator_apply", half_gen)
        enc = ad.AdaptationTrainer._encode

        def half_enc(self, name, images, return_hidden=()):
            n = images.shape[0] // 2            # [trainable; frozen]
            keep = torch.cat([torch.arange(n // 2), n + torch.arange(n // 2)])
            return enc(self, name, images[keep.to(images.device)],
                       return_hidden)
        patch(ad.AdaptationTrainer, "_encode", half_enc)
    elif fault == "altered":
        gen = sg2.generator_apply

        def altered_images(*a, **k):
            img = gen(*a, **k)
            return img + first_only(img, 0.25)
        patch(sg2, "generator_apply", altered_images)
        disc = sg2.discriminator_apply

        def altered_logits(*a, **k):
            logits = disc(*a, **k)
            return logits + first_only(logits, 1.0)
        patch(sg2, "discriminator_apply", altered_logits)
        pair = ad.AdaptationTrainer._images

        def altered_pair(self, *a, **k):
            frozen, trainable = pair(self, *a, **k)
            return frozen, trainable + first_only(trainable, 0.25)
        patch(ad.AdaptationTrainer, "_images", altered_pair)
    elif fault != "none":
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def train_control(c, t, seed: int, device, precision, fault):
    """Three batches of the training cell, control against reference, on
    seeded batches of the cell's dataset."""
    import numpy as np
    import torch

    from portbench import data
    from portbench.reference import compare, train_ref

    imgs = torch.from_numpy(data.images(seed, t["images"], c["img_resolution"],
                                        c["img_channels"])).permute(0, 3, 1, 2)
    pick = np.random.default_rng(seed)
    reals = [imgs[pick.integers(0, len(imgs), t["batch"])] for _ in range(3)]
    weights = train_ref.make_weights(c, t, seed)
    inputs = train_ref.draws(seed, t["batch"], c["z_dim"], len(reals))
    with planted(fault):
        ctl = train_ref.follow(c, t, weights, inputs, reals, device,
                               precision)
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    ref = train_ref.follow(c, t, weights, inputs, reals, device, "float32")
    return compare.train_checks(ctl, ref)


def generate_control(c, t, seed: int, device, precision, fault):
    from portbench.reference import compare, generate_ref

    params = generate_ref.make_weights(c, seed, device)
    out = {}
    for i in range(t["compared_batches"]):
        z = generate_ref.latents(seed, i, t["batch"], c["z_dim"], device)
        with planted(fault):
            ctl = generate_ref.generate(c, params, z, precision)
        for k, v in compare.image_checks(
                ctl, generate_ref.generate(c, params, z)).items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def adapt_control(c, t, seed: int, device, precision, fault):
    from portbench.reference import adapt_ref, compare

    inputs = adapt_ref.make_inputs(c, t, seed, device)
    with planted(fault):
        ctl = adapt_ref.follow(c, t, seed, inputs, device, precision)
    ref = adapt_ref.follow(c, t, seed, inputs, device, "float32")
    return compare.adapt_checks(ctl, ref)


CONTROLS = {"train": train_control, "generate": generate_control,
            "adapt": adapt_control}


def verdict(readings, limits):
    """The readings judged under the cell's limits, as a run judges them:
    (correct, {failed number: [reading, limit]})."""
    from portbench import harness
    from portbench.reference import compare

    checks = [harness.Check(k, v, float(limits[k]))
              for k, v in compare.judged(readings, limits).items()]
    failed = {c.name: [c.value, c.limit] for c in checks if not c.ok}
    return bool(checks) and not failed, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default="none",
                    choices=("none", "half_batch", "altered"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    fn = CONTROLS[cell.traffic["job"]]
    precision = "control" if args.fault == "none" else "float32"
    for seed in (int(s) for s in args.seeds.split(",")):
        readings = fn(cell.config, cell.traffic, seed, args.device, precision,
                      args.fault)
        correct, failed = verdict(readings, cell.traffic["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault if args.fault != "none"
                          else precision, "readings": readings,
                          "correct": correct, "failed": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
