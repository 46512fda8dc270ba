"""The program's own spans (``gagan_tpu_torch.utils.observability``) as
the per-layer readers take them.  A span records only while a profiler
records, so in a traced run the totals cover the traced window and
nothing else; an untraced run records none.  A program without the
recorder gives no totals, and every reader of them then returns None."""

from __future__ import annotations

from typing import Any, Dict, Optional

HOST_READ = "host_read."


def totals() -> Dict[str, Dict[str, Any]]:
    """``span_totals()``: {name: {"count", "host_ms", "device_ms"}}, or {}
    where the program has no span recorder."""
    from gagan_tpu_torch.utils import observability

    read = getattr(observability, "span_totals", None)
    return read() if read is not None else {}


def per_step(r, value: Optional[float]) -> Optional[float]:
    """``value`` over the window's steps (batches, adaptation steps)."""
    steps = r.work.get("steps") or 0
    if value is None or steps <= 0:
        return None
    return value / steps


def device_pct(r, name: str) -> Optional[float]:
    """The device time of span ``name`` as a share of the window."""
    t = totals().get(name)
    if t is None or t["device_ms"] is None or r.trace.window_s <= 0:
        return None
    return 100.0 * t["device_ms"] / (1000.0 * r.trace.window_s)


def device_ms_per_call(name: str) -> Optional[float]:
    t = totals().get(name)
    if t is None or t["device_ms"] is None or t["count"] <= 0:
        return None
    return t["device_ms"] / t["count"]


def host_reads(field: str) -> Optional[float]:
    """The count (``field="count"``) or host milliseconds
    (``"host_ms"``) of every ``host_read.*`` span: 0 where the program
    recorded spans but made no host read, None where it recorded none."""
    t = totals()
    if not t:
        return None
    return float(sum(v[field] for k, v in t.items()
                     if k.startswith(HOST_READ)))
