"""Device time of the path-length phase a call (the ``step.g_reg``
span)."""

from portbench import spans


def read(r):
    return spans.device_ms_per_call("step.g_reg")
