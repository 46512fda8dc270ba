"""The checks that decide ``correct`` fail a broken timed path.  Each test
skips the look for a chip, drives the rest of a tiny CPU run (the program
in float32, so that a sound run reads nearly nothing) with one fault
planted underneath, and sees ``correct`` come out false under the cell's
own limits: a step that returns its state unchanged, half of the batch
left out (the mean taken over the rest), an answer altered where it is
produced (a generated image by 0.25; in a training step, a D logit by
1).  (One chip: no exchange between chips to leave out.)"""

import copy

import pytest
import torch

import tiny


def _unchanged_step(monkeypatch):
    from gagan_tpu_torch.train import train_step as ts

    make = ts.make_fused_step

    def make_broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(state, *a, **k):
            # The step's arithmetic runs, its parameters and optimizer state
            # are dropped; the image count advances, as the loop needs.
            stepped, metrics = step(copy.deepcopy(state), *a, **k)
            state.cur_nimg = stepped.cur_nimg
            return state, metrics
        return broken
    monkeypatch.setattr(ts, "make_fused_step", make_broken)


def _half_batch(monkeypatch):
    from gagan_tpu_torch.train import gan_loss

    orig = gan_loss.gd_main_loss

    def half(cfg, g_cfg, d_cfg, g_params, d_params, real_img, real_c, z,
             gen_c, key, **kw):
        n = z.shape[0] // 2
        return orig(cfg, g_cfg, d_cfg, g_params, d_params, real_img[:n],
                    real_c, z[:n], gen_c, key, **kw)
    monkeypatch.setattr(gan_loss, "gd_main_loss", half)


def _altered_logit(monkeypatch):
    from gagan_tpu_torch.models import stylegan2 as sg2

    orig = sg2.discriminator_apply

    def altered(*a, **k):
        logits = orig(*a, **k)
        bump = torch.zeros_like(logits)
        bump[0] = 1.0
        return logits + bump
    monkeypatch.setattr(sg2, "discriminator_apply", altered)


TRAIN_FAULTS = {"unchanged": _unchanged_step, "half_batch": _half_batch,
                "altered": _altered_logit}


@pytest.mark.parametrize("cell", ["ffhq1024-fewshot10", "ffhq256-paper256"])
@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_caught(monkeypatch, cell, fault):
    TRAIN_FAULTS[fault](monkeypatch)
    assert tiny.run(cell)["correct"] is False


def _half_images(monkeypatch):
    from gagan_tpu_torch.models import stylegan2 as sg2

    orig = sg2.generator_apply

    def half(*a, **k):
        img = orig(*a, **k)
        img[img.shape[0] // 2:] = 0
        return img
    monkeypatch.setattr(sg2, "generator_apply", half)


def _altered_images(monkeypatch):
    from gagan_tpu_torch.models import stylegan2 as sg2

    orig = sg2.generator_apply

    def altered(*a, **k):
        img = orig(*a, **k)
        img[0] += 0.25
        return img
    monkeypatch.setattr(sg2, "generator_apply", altered)


@pytest.mark.parametrize("fault", [_half_images, _altered_images],
                         ids=["half_batch", "altered"])
def test_generate_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    assert tiny.run("ffhq1024-generate")["correct"] is False


def _adam_unchanged(monkeypatch):
    from gagan_tpu_torch.train import train_step as ts

    monkeypatch.setattr(ts.Adam, "update_",
                        lambda self, grads, state, params: state)


def _adapt_half_batch(monkeypatch):
    from gagan_tpu_torch.train import adaptation as ad

    orig = ad.AdaptationTrainer._encode

    def half(self, name, images, return_hidden=()):
        n = images.shape[0] // 2          # [trainable; frozen]
        keep = torch.cat([torch.arange(n // 2), n + torch.arange(n // 2)])
        return orig(self, name, images[keep.to(images.device)],
                    return_hidden)
    monkeypatch.setattr(ad.AdaptationTrainer, "_encode", half)


def _adapt_altered(monkeypatch):
    from gagan_tpu_torch.train import adaptation as ad

    orig = ad.AdaptationTrainer._images

    def altered(self, *a, **k):
        frozen, trainable = orig(self, *a, **k)
        bump = torch.zeros_like(trainable)
        bump[0] = 0.25
        return frozen, trainable + bump
    monkeypatch.setattr(ad.AdaptationTrainer, "_images", altered)


@pytest.mark.parametrize("fault", [_adam_unchanged, _adapt_half_batch,
                                   _adapt_altered],
                         ids=["unchanged", "half_batch", "altered"])
def test_adapt_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    assert tiny.run("ffhq1024-oneshot-clip")["correct"] is False


@pytest.mark.parametrize("cell", ["ffhq1024-fewshot10", "ffhq1024-generate",
                                  "ffhq1024-oneshot-clip"])
def test_sound_run_is_correct(cell):
    assert tiny.run(cell)["correct"] is True


@pytest.mark.parametrize("fault", ["none", "half_batch", "altered"])
def test_control_script_judges_its_readings(fault):
    """``control.py`` judges each seed's readings under the cell's own
    limits: the reference against itself is correct, a planted fault is
    not, and the numbers that failed are named."""
    from portbench import control, harness

    cell = harness.load_cell(tiny.ROOT, "ffhq256-paper256")
    o = tiny.overrides()
    c = {**cell.config, **o["config"]}
    t = {**cell.traffic, **o["traffic"]}
    readings = control.train_control(c, t, 2 ** 31 + 23, "cpu", "float32",
                                     fault)
    correct, failed = control.verdict(readings, t["limits"])
    assert correct is (fault == "none"), (readings, failed)
    assert set(failed) <= set(t["limits"]) and bool(failed) is (fault != "none")
