"""The share of the traced window in which no kernel, copy or fill ran
on the card: 1 - (union of the device spans) / (window)."""


def read(r):
    if r.trace.window_s <= 0 or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
