"""Device time of the R1 phase a call (the ``step.d_reg`` span)."""

from portbench import spans


def read(r):
    return spans.device_ms_per_call("step.d_reg")
