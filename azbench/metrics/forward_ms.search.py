"""Device-busy milliseconds of the operations launched inside the
benchmark's span ``forward`` around each call of the network, per call."""

from azbench.trace import forward_busy_ns

FOUND = 0.99  # the least share of operations whose launch the host pass must show


def read(rec):
    p = rec.host_pass
    if not p.complete or not p.ops:
        return None
    busy, calls, found = forward_busy_ns(p)
    if calls == 0 or found < FOUND or busy == 0:
        return None
    return busy / calls / 1e6
