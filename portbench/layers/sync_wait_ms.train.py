"""Host time spent in device-to-host reads a batch: the ``host_read.*``
spans' host milliseconds over the window's batches."""

from portbench import spans


def read(r):
    return spans.per_step(r, spans.host_reads("host_ms"))
