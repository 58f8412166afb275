"""The share of one traced ply's window in which no device
operation ran (device activity only, so the profiler adds least to the
host's time)."""

from azbench.trace import busy_ns


def read(rec):
    p = rec.device_pass
    if not p.complete or not p.ops:
        return None
    start, end = p.window
    return 100.0 * (1.0 - busy_ns(p.ops, p.window) / (end - start))
