"""The ADA pipe's forward as a share of the window: the device time of
the ``augment`` spans (its backward runs inside the phases' backward and
is not in them)."""

from portbench import spans


def read(r):
    return spans.device_pct(r, "augment")
