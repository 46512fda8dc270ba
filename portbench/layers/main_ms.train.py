"""Device time of the main phase a call: the ``step.gd_main`` span (the
simultaneous Gmain+Dmain), or ``step.g_main`` and ``step.d_main``
together, from its start event to its end event on the card's stream."""

from portbench import spans


def read(r):
    t = spans.totals()
    if "step.gd_main" in t:
        return spans.device_ms_per_call("step.gd_main")
    g, d = t.get("step.g_main"), t.get("step.d_main")
    if (g is None or d is None or g["device_ms"] is None
            or d["device_ms"] is None or g["count"] <= 0):
        return None
    return (g["device_ms"] + d["device_ms"]) / g["count"]
