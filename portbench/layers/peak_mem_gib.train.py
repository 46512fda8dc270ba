"""The device memory peak over the window (``max_memory_allocated``)."""


def read(r):
    if r.window_peak_bytes <= 0:
        return None
    return r.window_peak_bytes / 2 ** 30
