"""Generation cells: batches of images through the port's generator
forward (``models/stylegan2.py::generator_apply``, ``noise_mode="const"``,
the configuration's G with the fused level), each turned into uint8
images on the card as ``cli/generate.py`` converts them, dispatched ahead
with no host read per batch.

Set-up makes the weights on the card from the seed and runs ``warmup``
batches.  The window issues batches until its seconds have passed and
ends when the card has finished them.  A sample of the window's batches,
drawn from the seed as they come (reservoir sampling), is kept and
compared after the window with the reference's images of the same
latents."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import flops, harness, instrument, port
from portbench.reference import compare, generate_ref


def run(r: harness.Run) -> harness.Outcome:
    from gagan_tpu_torch.models import stylegan2 as sg2

    c, t = r.config, r.traffic
    batch, keep = t["batch"], t["compared_batches"]
    cfg = port.g_config(c)
    params = generate_ref.make_weights(c, r.seed, r.device)
    r.mark("weights")

    def forward(i):
        z = generate_ref.latents(r.seed, i, batch, c["z_dim"], r.device)
        with torch.no_grad():
            img = sg2.generator_apply(cfg, params, z, noise_mode="const")
        return generate_ref.to_uint8(img)

    for i in range(t["warmup"]):
        forward(-1 - i)
    levels = instrument.LevelCalls()
    pick = np.random.default_rng(r.seed)
    kept = {}
    with levels.installed():
        levels.on = r.trace
        r.start_window()
        n = 0
        while n == 0 or time.time() - r.window_start < r.window_seconds:
            u8 = forward(n)
            if len(kept) < keep:
                kept[n] = u8
            else:
                j = int(pick.integers(0, n + 1))
                if j < keep:
                    del kept[sorted(kept)[j]]
                    kept[n] = u8
            n += 1
        r.end_window()
        levels.on = False
    r.reduce_trace()

    work = dict(steps=n, images=n * batch,
                model_flops=n * batch * flops.generator_flops(c),
                model_peak=harness.PEAK_BF16, level_calls=levels.calls)
    checks = check(r, params, kept)
    del params, kept
    gc.collect()
    return harness.Outcome(
        attempted=n * batch, failed=0,
        end_to_end={"img_per_s": n * batch / r.window_s}, work=work,
        checks=checks)


def check(r: harness.Run, params, kept):
    c, t = r.config, r.traffic
    worst: dict = {}
    for i, u8 in sorted(kept.items()):
        z = generate_ref.latents(r.seed, i, t["batch"], c["z_dim"], r.device)
        ref = generate_ref.generate(c, params, z)
        for k, v in compare.image_checks(u8, ref).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return [harness.Check(k, v, float(t["limits"][k]))
            for k, v in sorted(worst.items())]
