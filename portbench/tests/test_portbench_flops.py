"""The operation and byte counters equal hand counts."""

import pytest

from portbench import flops

TINY = dict(img_resolution=8, img_channels=3, z_dim=4, w_dim=4,
            mapping_layers=2, channel_base=64, channel_max=8)


def test_level_forward_by_hand():
    ops, nbytes = flops.level_forward((2, 16, 4, 4), 8, 2, noise=True)
    assert ops == 2 * 2 * 9 * 16 * 8 * 16
    assert nbytes == (2 * 16 * 16 * 2 + 2 * 8 * 16 * 2
                      + 4 * (8 * 16 * 9 + 2 * 16 + 2 * 8 + 8 + 2 * 16))


def test_level_backward_by_hand():
    ops, _ = flops.level_backward((2, 16, 4, 4), 8, 2, False, False)
    assert ops == 2 * 2 * 9 * 16 * 8 * 16
    ops_w, _ = flops.level_backward((2, 16, 4, 4), 8, 2, False, True)
    assert ops_w == 2 * ops


def test_generator_by_hand():
    # channels: 4 -> min(64 // 4, 8) = 8, 8 -> 8.
    mapping = 2 * 2 * 4 * 4
    b4 = (2 * 4 * 8 + 2 * 9 * 8 * 8) + 2 * 9 * 8 * 8 * 16 \
        + (2 * 4 * 8 + 2 * 8 * 3 * 16)
    b8 = (2 * 4 * 8 + 2 * 9 * 8 * 8) + 2 * 9 * 8 * 8 * 16 \
        + 2 * 16 * 8 * 64 + 2 * 16 * 3 * 64 \
        + (2 * 4 * 8 + 2 * 9 * 8 * 8) + 2 * 9 * 8 * 8 * 64 \
        + (2 * 4 * 8 + 2 * 8 * 3 * 64)
    assert flops.generator_flops(TINY) == mapping + b4 + b8
    assert flops.generator_flops(TINY, mappings=2) == 2 * mapping + b4 + b8


def test_discriminator_by_hand():
    d = (2 * 3 * 8 * 64 + 2 * 9 * 8 * 8 * 64 + 2 * 16 * 8 * 64
         + 2 * 9 * 8 * 8 * 16 + 2 * 16 * 8 * 16 + 2 * 8 * 8 * 16
         + 2 * 9 * 9 * 8 * 16 + 2 * 16 * 8 * 8 + 2 * 8)
    assert flops.discriminator_flops(TINY) == d


def test_ffhq1024_generator_count():
    c = dict(img_resolution=1024, img_channels=3, z_dim=512, w_dim=512,
             mapping_layers=8, channel_base=32768, channel_max=512)
    assert flops.generator_flops(c) == pytest.approx(150.8e9, rel=1e-3)


def test_bound_is_the_larger():
    assert flops.bound_s(10.0, 1.0, 10.0, 10.0) == 1.0
    assert flops.bound_s(1.0, 10.0, 10.0, 1.0) == 10.0
