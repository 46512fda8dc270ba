"""The fused level's forward: the least time its recorded calls could
take on the card (operations or bytes, ``flops.level_forward``) over the
device time of its fold and conv kernels in the window."""

from portbench import flops, harness


def read(r):
    device_s = r.trace.fused_forward_s()
    calls = r.work.get("level_calls") or []
    if device_s <= 0 or not calls:
        return None
    bound = flops.level_bounds(
        calls, {"bfloat16": harness.PEAK_BF16, "float32": harness.PEAK_FP32},
        harness.PEAK_HBM, backward=False)
    return 100.0 * bound / device_s
