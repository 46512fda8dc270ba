"""Host time of one generator call a batch: the ``G.apply`` span (the
mapping and synthesis forwards as the host queues them; it waits when the
launch queue is full) over the window's batches."""

from portbench import spans


def read(r):
    t = spans.totals().get("G.apply")
    return spans.per_step(r, t and t["host_ms"])
