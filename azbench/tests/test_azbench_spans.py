"""The program's spans laid over a device pass, on a synthetic pass: idle
gaps put down to the innermost span, shares of a span and the spans nested
in it, and the readings that refuse a pass they cannot trust."""

from typing import NamedTuple

import pytest

from azbench import spans as sp
from azbench.trace import Op, Pass


class Span(NamedTuple):  # the fields of the program's ``utils/profiling.py::Span``
    name: str
    parent: int
    call: int
    start_ns: int
    end_ns: int


SIMS = 2


def simulation(first, parent, start):
    """A simulation's span at index ``first`` and its four parts, 100 ns each."""
    return [Span("mcts.simulation", parent, 1, start, start + 400),
            Span("mcts.select", first, 1, start, start + 100),
            Span("mcts.step_leaf", first, 1, start + 100, start + 200),
            Span("mcts.evaluate", first, 1, start + 200, start + 300),
            Span("mcts.backup", first, 1, start + 300, start + 400)]


def program_pass(**changes):
    spans = [Span("mcts.search", -1, 1, 0, 1000), Span("mcts.root", 0, 1, 0, 100)]
    spans += simulation(2, 0, 100) + simulation(7, 0, 500)
    spans += [Span("sync.select", 3, 1, 150, 200),  # in the first walk
              Span("engine.step", 4, 1, 210, 260),  # in the first leaf step
              Span("engine.step", -1, 0, 1000, 1050)]  # the ply's own step
    busy = [(0, 100), (140, 160), (190, 220), (240, 320), (380, 420), (480, 610), (690, 940),
            (960, 1010), (1040, 1060)]
    ops = [Op("k", a, b, n) for n, (a, b) in enumerate(busy)]
    p = sp.ProgramPass(Pass(ops, (0, 1100), True, [], {}), spans, 0, 5)
    return p._replace(**changes)


def test_idle_goes_to_the_innermost_span():
    got = sp.idle_by_program_span(program_pass())
    assert got == {"mcts.select": 40, "sync.select": 30, "engine.step": 20 + 30,
                   "mcts.evaluate": 60, "mcts.backup": 60, "mcts.step_leaf": 80,
                   "mcts.search": 20, "outside": 40}
    assert sum(got.values()) == 1100 - sum(b - a for a, b in [
        (0, 100), (140, 160), (190, 220), (240, 320), (380, 420), (480, 610), (690, 940),
        (960, 1010), (1040, 1060)])


def test_innermost_at_span_edges():
    spans = program_pass().spans
    at = sp.innermost(spans, [0, 99, 100, 150, 199, 200, 999, 1000, 1050])
    assert [spans[i].name if i >= 0 else None for i in at] == [
        "mcts.root", "mcts.root", "mcts.select", "sync.select", "sync.select",
        "mcts.step_leaf", "mcts.search", "engine.step", None]


def test_readings_count_the_spans_nested_in_a_part():
    pp = program_pass()
    assert sp.READINGS["select_idle_pct.search"](pp, SIMS) == pytest.approx(100 * 70 / 1100)
    # the leaf step's own engine step counts, the ply's does not
    assert sp.READINGS["leaf_step_idle_pct.search"](pp, SIMS) == pytest.approx(100 * 100 / 1100)
    assert sp.READINGS["backup_idle_pct.search"](pp, SIMS) == pytest.approx(100 * 60 / 1100)
    assert sp.READINGS["syncs_per_sim.search"](pp, SIMS) == 2.5


@pytest.mark.parametrize("broken", ["missing simulation", "missing part", "dropped",
                                    "incomplete", "no pass", "no device operation"])
def test_a_pass_that_cannot_be_trusted_reads_none(broken):
    pp = program_pass()
    pp, sims = {"missing simulation": (pp, SIMS + 1),
                "missing part": (pp._replace(spans=[
                    s._replace(name="mcts.other") if s.name == "mcts.evaluate" and s.start_ns > 500
                    else s for s in pp.spans]), SIMS),
                "dropped": (pp._replace(dropped=1), SIMS),
                "incomplete": (pp._replace(device=pp.device._replace(complete=False)), SIMS),
                "no pass": (None, SIMS),
                "no device operation": (pp._replace(device=pp.device._replace(ops=[])), SIMS),
                }[broken]
    assert all(read(pp, sims) is None for read in sp.READINGS.values())


def test_the_tool_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert sp.main(["--workload", "wide_10x256.selfplay", "--seed", "1"]) == 3
