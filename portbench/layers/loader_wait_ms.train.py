"""Host time the loop waited for a batch: the ``loop.next_batch`` span
(``next(loader)`` and the batch's copy to the card) over the window's
batches."""

from portbench import spans


def read(r):
    t = spans.totals().get("loop.next_batch")
    return spans.per_step(r, t and t["host_ms"])
