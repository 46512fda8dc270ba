"""The fused level's backward: the least time the gradients it was asked
for could take (``flops.level_backward``: dx and the styles' through the
conv, the weight's only where it trains) over the device time of the
kernels launched inside its ``fused_modconv3x3_bwd`` range."""

from portbench import flops, harness


def read(r):
    device_s = r.trace.ranges_s.get(harness.BWD_RANGE, 0.0)
    calls = [c for c in r.work.get("level_calls") or [] if c["backward"]]
    if device_s <= 0 or not calls:
        return None
    bound = flops.level_bounds(
        calls, {"bfloat16": harness.PEAK_BF16, "float32": harness.PEAK_FP32},
        harness.PEAK_HBM, backward=True)
    return 100.0 * bound / device_s
