"""Host time to issue one adaptation step: the ``adapt.step`` span
(``train_step_async``, which queues the step's work and returns) over
the window's steps."""

from portbench import spans


def read(r):
    t = spans.totals().get("adapt.step")
    return spans.per_step(r, t and t["host_ms"])
