"""One-shot adaptation cells: the port's ``AdaptationTrainer`` (the
``td_single`` trainer of ``cli/adapt.py``, from the mix's YAML blocks
through the command's own ``adaptation_config``) on weights, a CLIP tower,
text embeddings and starting offsets that the benchmark makes on the card
from the seed (``reference/adapt_ref.py::make_inputs``).

Set-up builds the trainer and runs ``warm_steps`` of its steps
(``train_step_async``, the window's own call); the first three are
recorded for the check (the first step's trainable images, losses,
Adam's moments after the first, each offsets leaf's change after the
third).  The window runs blocks of
``log_every`` steps, each ending in the host read of the losses that
``AdaptationTrainer.train`` makes, until the window's seconds have passed.  After
it, the reference follows the same three steps in float32."""

from __future__ import annotations

import gc
import time

from portbench import flops, harness, instrument, port
from portbench.reference import adapt_ref, compare
from portbench.reference.frozen.utils.rng import Rng


def run(r: harness.Run) -> harness.Outcome:
    from gagan_tpu_torch.cli import adapt as adapt_cli
    from gagan_tpu_torch.clip import model as clip_model
    from gagan_tpu_torch.train import adaptation as ad

    c, t = r.config, r.traffic
    cfg = adapt_cli.adaptation_config(t["adapt_config"])
    if "adapt_cfg" in r.overrides:       # tiny CPU runs of the tests
        cfg = r.overrides["adapt_cfg"](cfg)
    inputs = adapt_ref.make_inputs(c, t, r.seed, r.device)
    r.mark("inputs")
    g_params, ccfg_ref, cparams, emb, offsets = inputs
    ccfg = clip_model.CLIPConfig(**{
        f.name: getattr(ccfg_ref, f.name)
        for f in ccfg_ref.__dataclass_fields__.values()})
    trainer = ad.AdaptationTrainer(
        cfg, port.g_config(c), g_params, {n: (ccfg, cparams) for n in emb},
        Rng(r.seed), emb, device=r.device, offsets=offsets)

    before = adapt_ref.offsets_snapshot(trainer.offsets)
    prog = {"losses": []}
    for i in range(t["warm_steps"]):
        with adapt_ref.first_images(ad.AdaptationTrainer, prog, i == 0):
            out = trainer.train_step_async()
        if i < 3:
            prog["losses"].append(adapt_ref.losses(out))
        if i == 0:
            prog["first"] = adapt_ref.opt_norms(trainer.opt_state)
        if i == 2:
            prog["change"] = adapt_ref.change_norms(before, trainer.offsets)
    ad._to_host(out)

    levels = instrument.LevelCalls()
    every = cfg.log_every
    with levels.installed():
        levels.on = r.trace
        r.start_window()
        steps = 0
        while steps == 0 or time.time() - r.window_start < r.window_seconds:
            for _ in range(every):
                out = trainer.train_step_async()
            ad._to_host(out)
            steps += every
        r.end_window()
        levels.on = False
    r.reduce_trace()
    del trainer, out
    gc.collect()

    batch = cfg.batch_size
    vit = c["clip_vit_b32"]
    step_flops = (2 * batch * flops.mapping_flops(c)
                  + 3 * batch * flops.synthesis_flops(c)
                  + 3 * batch * flops.vit_flops(
                      vit["vision_width"], vit["vision_layers"],
                      vit["vision_patch_size"], vit["image_resolution"],
                      vit["embed_dim"]))
    work = dict(steps=steps, model_flops=steps * step_flops,
                model_peak=harness.PEAK_BF16, level_calls=levels.calls)

    ref = adapt_ref.follow(c, t, r.seed, inputs, r.device)
    gaps = compare.judged(compare.adapt_checks(prog, ref), t["limits"])
    checks = [harness.Check(k, v, float(t["limits"][k]))
              for k, v in gaps.items()]
    return harness.Outcome(
        attempted=steps, failed=0,
        end_to_end={"adapt_steps_per_s": steps / r.window_s}, work=work,
        checks=checks)
