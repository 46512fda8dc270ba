"""Device-to-host reads a batch: the ``host_read.*`` spans (the step's
statistics, the ADA p reads, the abort poll, the ADA warp's and exact
geometry's reads) over the window's batches.  Each read waits for the
card's queue to drain."""

from portbench import spans


def read(r):
    return spans.per_step(r, spans.host_reads("count"))
