"""The marker and completeness arithmetic copied from the program's
profilers, and the reduction of a pass, on synthetic device records."""

from azbench import trace
from azbench.trace import Op, Pass

M = "void at::cuda::spin_kernel(long)"


def test_split_finds_the_call_between_markers():
    recs = [Op(M, 0, 10, 0), Op(M, 10, 20, 0), Op("x", 30, 40, 1), Op(M, 45, 46, 0),
            Op("y", 50, 60, 2), Op(M, 70, 80, 0)]
    ops, window, complete = trace.split(recs[::-1])
    assert [o.name for o in ops] == ["x", "y"] and window == (20, 70) and complete
    # leading records lost: no marker before the call, so not complete
    ops, window, complete = trace.split(recs[2:])
    assert not complete and window == (30, 70)
    ops, window, complete = trace.split(recs[:2])
    assert ops == [] and not complete
    assert not trace.split(recs[:-1])[2]


def test_busy_idle_and_spans():
    ops = [Op("a", 10, 30, 1), Op("b", 20, 40, 2), Op("c", 60, 70, 3)]
    assert trace.busy_ns(ops, (0, 100)) == 40
    assert trace.idle_gaps(ops, (0, 100)) == [(0, 10), (40, 60), (70, 100)]
    spans = [("search", 0, 80), ("forward", 35, 65), ("engine", 66, 80)]
    p = Pass(ops, (0, 100), True, spans, {1: 36, 2: 5, 3: 64})
    assert trace.idle_by_span(p) == {"search": 10, "forward": 20, "outside": 30}
    assert trace.span_at(spans, 70) == "engine"
    busy, calls, found = trace.forward_busy_ns(p)
    assert (busy, calls, found) == (20 + 10, 1, 1.0)
    busy, calls, found = trace.forward_busy_ns(p._replace(launches={1: 36}))
    assert found == 1 / 3
