"""Spans, the walk's host-sync counter and the network's FLOPs.

- :class:`PhaseTimer`: spans kept in memory, each with its name, its
  parent's index, the id of the search call it belongs to and its start
  and end in ns on the clock ``torch.profiler`` stamps host events with
  (``time.time_ns``), so they can be laid over a device trace; a phase may
  fence device work first (kernels are launched asynchronously, so without
  a fence time lands in the wrong phase). ``summary()`` gives each name's
  count, total and self time.
- :func:`tracing` turns the program's own spans on (:func:`span`,
  :func:`spanned`: ``mcts.*`` in the search, ``engine.*`` in the engine,
  ``sync.*`` at the host reads) and yields the recorder. Off, a span costs
  one boolean test: no clock, no allocation, no ``record_function``. No
  program span fences.
- :func:`host_bool`: the one explicit host read of the search and ply
  loops, inside its ``sync.*`` span; the walk's reads also count in
  ``mcts._select.syncs``, reset by whoever reads it.
- :func:`model_flops_per_board`, as in the JAX package.

The recorder is for one thread: the spans of another would nest wrongly.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

CAPACITY = 1 << 20  # spans a recorder keeps; later ones are dropped and counted


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the recorder's list; -1 for none
    call: int  # id of the search call it belongs to; 0 outside any
    start_ns: int  # time.time_ns(), the clock of torch.profiler's host events
    end_ns: int  # -1 while open


def _synchronize(fence) -> None:
    """Wait for the device work behind ``fence``: a tensor (or a list or
    tuple of them) or a device."""
    if isinstance(fence, (list, tuple)):
        for f in fence:
            _synchronize(f)
        return
    device = fence.device if isinstance(fence, torch.Tensor) else torch.device(fence)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Phase:
    """One span of a :class:`PhaseTimer` (a context manager)."""

    __slots__ = ("timer", "name", "call", "fence")

    def __init__(self, timer: "PhaseTimer", name: str, call: bool = False, fence=None):
        self.timer, self.name, self.call, self.fence = timer, name, call, fence

    def __enter__(self):
        self.timer._open(self.name, self.call)

    def __exit__(self, *exc):
        if self.fence is not None:
            _synchronize(self.fence)
        self.timer._close()
        return False


class PhaseTimer:
    """Spans kept in memory, at most :data:`CAPACITY` of them; those past
    it are dropped and counted in ``dropped``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._rows: List[list] = []  # a Span's fields per span, in the order they opened
        self.dropped = 0
        self._open_rows: List[int] = []  # the open spans' rows, innermost last; -1 dropped
        self._calls = 0

    @property
    def spans(self) -> List[Span]:
        return [Span(*row) for row in self._rows]

    def phase(self, name: str, fence=None) -> _Phase:
        """A context manager that records the span ``name``, nested in the
        span open around it, after waiting for the device work behind
        ``fence`` at its end."""
        return _Phase(self, name, fence=fence)

    def _open(self, name: str, call: bool) -> None:
        rows, open_rows = self._rows, self._open_rows
        if len(rows) >= CAPACITY:
            self.dropped += 1
            open_rows.append(-1)
            return
        parent = open_rows[-1] if open_rows else -1
        if call:
            self._calls += 1
            call_id = self._calls
        else:
            call_id = rows[parent][2] if parent >= 0 else 0
        open_rows.append(len(rows))
        rows.append([name, parent, call_id, time.time_ns(), -1])

    def _close(self) -> None:
        end = time.time_ns()
        row = self._open_rows.pop()
        if row >= 0:
            self._rows[row][4] = end

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Each name's closed spans: count, total, self (less the time its
        child spans cover) and mean seconds."""
        spans = self.spans
        child_ns = [0] * len(spans)
        for s in spans:
            if s.parent >= 0 and s.end_ns >= 0:
                child_ns[s.parent] += s.end_ns - s.start_ns
        out: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"total_s": 0.0, "self_s": 0.0, "count": 0})
        for s, inner in zip(spans, child_ns):
            if s.end_ns >= 0:
                row = out[s.name]
                row["count"] += 1
                row["total_s"] += (s.end_ns - s.start_ns) / 1e9
                row["self_s"] += (s.end_ns - s.start_ns - inner) / 1e9
        for row in out.values():
            row["mean_s"] = row["total_s"] / row["count"]
        return dict(out)

    def report(self) -> str:
        lines = ["phase                total       self    calls     mean"]
        for k, v in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{k:18s} {v['total_s']:8.3f}s {v['self_s']:8.3f}s {v['count']:8d} "
                         f"{v['mean_s'] * 1e3:8.3f}ms")
        if self.dropped:
            lines.append(f"({self.dropped} spans dropped past {CAPACITY})")
        return "\n".join(lines)


_on = False  # whether the program's spans are recorded
_recorder: Optional[PhaseTimer] = None


class _Off:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, a, b, c):
        return False


_OFF = _Off()


def span(name: str, call: bool = False):
    """A context manager: the program's span ``name`` (a new search call
    with ``call``) while :func:`tracing` is on, nothing otherwise."""
    if not _on:
        return _OFF
    return _Phase(_recorder, name, call)


def spanned(name: str):
    """Decorator: each call of the function inside the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Phase(_recorder, name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def tracing() -> Iterator[PhaseTimer]:
    """Record the program's spans into a new :class:`PhaseTimer`, which it
    yields, until the block ends."""
    global _on, _recorder
    outer = _on, _recorder
    _recorder = PhaseTimer()
    _on = True
    try:
        yield _recorder
    finally:
        _on, _recorder = outer


def host_bool(flag: torch.Tensor, name: str, site=None) -> bool:
    """``bool(flag)``, a host read that waits for the device work before it,
    inside the span ``name`` (``sync.*``) while tracing; counted in
    ``site.syncs`` where ``site``, the function making the read, keeps a
    count."""
    if site is not None:
        site.syncs += 1
    with span(name):
        return bool(flag)


def model_flops_per_board(num_blocks: int = 10, num_filters: int = 128,
                          board_size: int = 8) -> float:
    """Forward FLOPs per board for the dual-head ResNet (2x MACs)."""
    s2 = board_size * board_size
    f = num_filters
    stem = 2 * s2 * 9 * 3 * f
    blocks = num_blocks * 2 * (2 * s2 * 9 * f * f)
    policy = 2 * s2 * f * 2 + 2 * (2 * s2) * (s2 + 1)
    value = 2 * s2 * f * 1 + 2 * s2 * 256 + 2 * 256
    return float(stem + blocks + policy + value)
