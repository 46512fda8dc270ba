"""Device-to-host reads an adaptation step: the ``host_read.*`` spans
(the losses' read every ``log_every`` steps, and any other) over the
window's steps."""

from portbench import spans


def read(r):
    return spans.per_step(r, spans.host_reads("count"))
