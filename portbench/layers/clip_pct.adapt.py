"""The CLIP tower's forward as a share of the window: the device time of
the ``clip.encode_image`` spans (its backward runs inside the step's
``autograd.grad`` and is not in them)."""

from portbench import spans


def read(r):
    return spans.device_pct(r, "clip.encode_image")
