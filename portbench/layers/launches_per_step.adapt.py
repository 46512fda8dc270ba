"""Kernel launch calls on the host in the traced window, per step."""


def read(r):
    steps = r.work.get("steps") or 0
    if steps <= 0 or r.trace.launches <= 0:
        return None
    return r.trace.launches / steps
