"""The model's operations in the window (counted from shapes by the
job, ``work["model_flops"]``) over the window's time and the card's
bf16 peak."""


def read(r):
    if r.trace.busy_s <= 0 or not r.work.get("model_flops"):
        return None
    return 100.0 * r.work["model_flops"] / (r.trace.window_s
                                            * r.work["model_peak"])
