"""The program's own spans laid over a device trace.

A third traced ply, after the two of :func:`azbench.run.profile`: device
activity only (as the pass the idle share is read from), with the
program's span recorder on (``utils/profiling.py::tracing``). The program
stamps its spans on the clock that ``torch.profiler`` stamps host events
with, so each idle gap of the device can be put down to the innermost
program span the host was in at the gap's middle: the select walk
(``mcts.select``), the leaf step (``mcts.step_leaf``), the expansion and
backup (``mcts.backup``), and so on. The walk's host syncs are the
program's counter ``mcts._select.syncs`` over the same session.

    python3 -m azbench.spans --workload <cell> --seed <n> --seconds <s> [--out file.json]

plays one window of a cell's games and reads this pass over the next ply.
The benchmark's runs do not take this pass yet (``PERF.md``, Open
questions); when ``run.profile`` does, :func:`measure` and :func:`main`
go, and the metric files read :data:`READINGS`. A program without the
recorder gives no pass, and every reading is None.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence

from . import trace

PARTS = ("mcts.select", "mcts.step_leaf", "mcts.evaluate", "mcts.backup")


class ProgramPass(NamedTuple):
    device: trace.Pass  # device activity only, profiled with the recorder on
    spans: List  # the program's spans (profiling.Span) of that session
    dropped: int  # spans the recorder dropped in it
    syncs: int  # mcts._select.syncs over it


def program_pass(ply) -> Optional[ProgramPass]:
    """Profile ``ply`` (one ply of the program's games) with the recorder
    on; None where the program has no recorder or counter. The recorder and
    the counter start again with each session, so they hold the spans and
    syncs of the session :func:`azbench.trace.traced` returns."""
    from othello_reinforcement_learning_test_tpu_torch.search import mcts
    from othello_reinforcement_learning_test_tpu_torch.utils import profiling
    if not hasattr(profiling, "tracing") or not hasattr(mcts._select, "syncs"):
        return None
    with profiling.tracing() as rec:
        def before():
            rec.reset()
            mcts._select.syncs = 0
        p = trace.traced(ply, host=False, before=before)
        return ProgramPass(p, list(rec.spans), rec.dropped, mcts._select.syncs)


def innermost(spans: Sequence, times: Sequence[int]) -> List[int]:
    """For each of ``times`` (ascending), the index of the innermost closed
    span that holds it (start <= t < end), or -1. The spans nest (one
    thread), so the open ones at any time form one chain."""
    order = sorted((i for i, s in enumerate(spans) if s.end_ns >= 0),
                   key=lambda i: spans[i].start_ns)
    out, chain, k = [], [], 0
    for t in times:
        while k < len(order) and spans[order[k]].start_ns <= t:
            i = order[k]
            while chain and spans[chain[-1]].end_ns <= spans[i].start_ns:
                chain.pop()
            chain.append(i)
            k += 1
        while chain and spans[chain[-1]].end_ns <= t:
            chain.pop()
        out.append(chain[-1] if chain else -1)
    return out


def _gaps(pp: ProgramPass):
    gaps = trace.idle_gaps(pp.device.ops, pp.device.window)
    return gaps, innermost(pp.spans, [(a + b) // 2 for a, b in gaps])


def idle_by_program_span(pp: ProgramPass) -> Dict[str, int]:
    """Idle nanoseconds of the pass's window by the innermost program span
    at each gap's middle ("outside" where none)."""
    out: Dict[str, int] = {}
    for (a, b), i in zip(*_gaps(pp)):
        name = pp.spans[i].name if i >= 0 else "outside"
        out[name] = out.get(name, 0) + b - a
    return out


def whole(pp: Optional[ProgramPass], sims: int) -> bool:
    """A pass to read: complete, no span dropped, and ``sims`` simulation
    spans, each with one span of each part."""
    if pp is None or not pp.device.complete or not pp.device.ops or pp.dropped:
        return False
    parts: Dict[int, List[str]] = {}
    for s in pp.spans:
        parts.setdefault(s.parent, []).append(s.name)
    simulations = [i for i, s in enumerate(pp.spans) if s.name == "mcts.simulation"]
    return len(simulations) == sims and all(
        sorted(n for n in parts.get(i, []) if n in PARTS) == sorted(PARTS) for i in simulations)


def idle_share(pp: Optional[ProgramPass], sims: int, name: str) -> Optional[float]:
    """The share (%) of the pass's window with the device idle while the
    innermost program span at the gap's middle is ``name`` or nested in
    it; None for a pass :func:`whole` refuses."""
    if not whole(pp, sims):
        return None

    def under(i):
        while i >= 0:
            if pp.spans[i].name == name:
                return True
            i = pp.spans[i].parent
        return False

    idle = sum(b - a for (a, b), i in zip(*_gaps(pp)) if under(i))
    start, end = pp.device.window
    return 100.0 * idle / (end - start)


def syncs_per_sim(pp: Optional[ProgramPass], sims: int) -> Optional[float]:
    """The walk's host syncs (the program's counter) a simulation."""
    if not whole(pp, sims):
        return None
    return pp.syncs / sims


# each reads (the pass, the cell's simulations a search)
READINGS = {"select_idle_pct.search": lambda pp, sims: idle_share(pp, sims, "mcts.select"),
            "leaf_step_idle_pct.search": lambda pp, sims: idle_share(pp, sims, "mcts.step_leaf"),
            "backup_idle_pct.search": lambda pp, sims: idle_share(pp, sims, "mcts.backup"),
            "syncs_per_sim.search": syncs_per_sim}


def measure(cell, seed: int, seconds: float, device) -> Dict:
    """One window of the cell's warmed games, then this pass over the next
    ply: its idle share, its idle by innermost span and the readings."""
    import torch

    from .run import power_limit_w, prepare, window

    sess = prepare(cell, seed, device)
    sess.ply()  # builds and warms every kernel and shape
    sess.play.reset()
    window(sess, seconds, seed, device)  # the games where a run's passes find them
    pp = program_pass(sess.ply)
    out = {"device": torch.cuda.get_device_name(device), "power_limit_w": power_limit_w()}
    if pp is not None:
        start, end = pp.device.window
        sims = cell.traffic["num_simulations"]
        out.update(program_pass_idle_pct=100.0 * (1 - trace.busy_ns(pp.device.ops, pp.device.window)
                                                  / (end - start)),
                   program_pass_complete=pp.device.complete, dropped=pp.dropped,
                   spans=len(pp.spans), syncs=pp.syncs,
                   idle_by_program_span={k: v / 1e9 for k, v in sorted(
                       idle_by_program_span(pp).items(), key=lambda kv: -kv[1])},
                   **{k: f(pp, sims) for k, f in READINGS.items()})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m azbench.spans")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch

    from .spec import load_cell
    if not torch.cuda.is_available():
        print("azbench.spans: needs a CUDA card", file=sys.stderr)
        return 3
    out = measure(load_cell(args.workload), args.seed, args.seconds, torch.device("cuda", 0))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
