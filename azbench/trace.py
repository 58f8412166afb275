"""One search call under ``torch.profiler``, read into device operations,
the benchmark's host spans and the idle time between.

The marker arithmetic is that of the program's profilers
(``profilers/common.py``), copied so that the yardstick stays here: a
profiler session loses a run of device records at its start, so the call
runs between two runs of marker kernels (``torch.cuda._sleep``, which the
program never launches) and counts as complete only when a marker
survives on each side of it and an operation of it between them; after an
incomplete session the next one's marker runs are longer. The traced
window runs from the end of the last marker before the call to the start
of the first marker after it.

Two passes are read: one with device activity only, whose host overhead is
least (the operations, the busy time, the idle share), and one with the
host's activity too (the benchmark's spans, and each operation's launch
on the host), whose idle gaps the profiler's own host work lengthens.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

MARKER = "spin_kernel"
PADS = (64, 256, 1024)  # marker kernels each side: the first session's, then longer
SESSIONS = 4  # sessions tried at most for one complete pass
SPANS = ("search", "forward", "engine")  # the benchmark's host spans, outermost first


class Op(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    correlation: int


class Pass(NamedTuple):
    ops: List[Op]  # the call's device operations, in start order
    window: Tuple[int, int]  # ns: the end of the markers before, the start of those after
    complete: bool
    spans: List[Tuple[str, int, int]]  # the benchmark's host spans (host pass only)
    launches: Dict[int, int]  # correlation id -> the host time of the launch (host pass only)


def busy_ns(ops: List[Op], window: Tuple[int, int]) -> int:
    """Nanoseconds of ``window`` in which some operation ran."""
    total, reach = 0, window[0]
    for op in ops:
        start, end = max(op.start_ns, reach), min(op.end_ns, window[1])
        if end > start:
            total += end - start
        reach = max(reach, op.end_ns)
    return total


def idle_gaps(ops: List[Op], window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The stretches of ``window`` in which no operation ran."""
    gaps, reach = [], window[0]
    for op in ops + [Op("", window[1], window[1], -1)]:
        if op.start_ns > reach:
            gaps.append((reach, min(op.start_ns, window[1])))
        reach = max(reach, op.end_ns)
    return [g for g in gaps if g[1] > g[0]]


def span_at(spans: List[Tuple[str, int, int]], t: int) -> str:
    """The innermost benchmark span the host was in at ``t``; "outside"."""
    inside = [name for name, start, end in spans if start <= t < end]
    return max(inside, key=SPANS.index) if inside else "outside"


def split(device: List[Op]) -> Tuple[List[Op], Tuple[int, int], bool]:
    """A session's device records -> (the call's operations, the traced
    window, whether the pass is complete): the operations between the
    first and the last that is not a marker, less any marker among them;
    complete when markers survive on both sides."""
    device = sorted(device, key=lambda op: op.start_ns)
    is_marker = [MARKER in op.name for op in device]
    if False not in is_marker:
        return [], (0, 0), False
    first = is_marker.index(False)
    last = len(device) - 1 - is_marker[::-1].index(False)
    ops = [op for op, m in zip(device[first:last + 1], is_marker[first:last + 1]) if not m]
    complete = first > 0 and last < len(device) - 1
    window = (device[first - 1].end_ns if first else ops[0].start_ns,
              device[last + 1].start_ns if last < len(device) - 1 else ops[-1].end_ns)
    return ops, window, complete


def _session(call: Callable[[], object], host: bool, pad: int) -> Pass:
    from torch.profiler import ProfilerActivity, profile

    def markers():
        for _ in range(pad):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        markers()
        call()
        torch.cuda.synchronize()
        markers()
    device, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not (e.is_user_annotation() or e.name() in SPANS):
                device.append(Op(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                                 e.correlation_id()))
        else:
            cpu.append(e)
    ops, window, complete = split(device)
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in cpu if e.name() in SPANS]
    wanted = {op.correlation for op in ops}
    launches = {e.correlation_id(): e.start_ns() for e in cpu
                if e.correlation_id() in wanted and e.name().startswith("cu")}
    return Pass(ops, window, complete, spans, launches)


def traced(call: Callable[[], object], host: bool,
           before: Optional[Callable[[], None]] = None) -> Pass:
    """Profile ``call`` until a pass is complete or :data:`SESSIONS` ran
    (the fullest pass then, marked incomplete); ``before`` runs ahead of
    each session, outside it."""
    passes = []
    for i in range(SESSIONS):
        if before is not None:
            before()
        torch.cuda.synchronize()
        p = _session(call, host, PADS[min(i, len(PADS) - 1)])
        if p.complete:
            return p
        passes.append(p)
    return max(passes, key=lambda p: len(p.ops))


def forward_busy_ns(p: Pass) -> Tuple[int, int, float]:
    """(device-busy ns of the operations launched inside a "forward" span,
    the number of such spans, the share of operations whose launch was
    found on the host)."""
    fwd = sorted((s, e) for name, s, e in p.spans if name == "forward")
    starts = [s for s, _ in fwd]
    total, found = 0, 0
    for op in p.ops:
        t = p.launches.get(op.correlation)
        if t is None:
            continue
        found += 1
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < fwd[i][1]:
            total += op.end_ns - op.start_ns
    return total, len(fwd), found / max(len(p.ops), 1)


def idle_by_span(p: Pass) -> Dict[str, int]:
    """Idle nanoseconds of the traced window by the benchmark span the host
    was in at each gap's middle."""
    out: Dict[str, int] = {}
    for start, end in idle_gaps(p.ops, p.window):
        name = span_at(p.spans, (start + end) // 2)
        out[name] = out.get(name, 0) + end - start
    return out
