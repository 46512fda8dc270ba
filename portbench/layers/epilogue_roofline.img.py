"""The synthesis layers' epilogue kernel: the least time its launches in
the window could take, the bytes they had to move (the program's own
tally, ``synthesis_epilogue.traced_bytes``, counted while the profiler
records) at the card's HBM bandwidth, over the device time of its kernel
in the window.  A program without the kernel gives nothing."""

from portbench import harness

KERNEL = "synthesis_epilogue_kernel"


def read(r):
    try:
        from gagan_tpu_torch.ops import synthesis_epilogue as se
    except ImportError:
        return None
    nbytes = getattr(getattr(se, "synthesis_epilogue", None),
                     "traced_bytes", 0)
    device_s = sum(s for name, s in r.trace.kernel_s.items()
                   if KERNEL in name)
    if device_s <= 0 or not nbytes:
        return None
    return 100.0 * nbytes / harness.PEAK_HBM / device_s
