"""The benchmark's harness: one cell, one seed, one process.

    python3 -m azbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run loads the cell's weights (or draws them on the card from the seed)
and builds the program's forward (``FusedInference`` with the
configuration's trunk kernel). Its games then play in lockstep from the
opening as the program's self-play plays them (:class:`SelfPlay`), one
ply a search call. One ply builds and warms every kernel and shape; that,
and the games' return to the opening, is set-up (``setup_s``, from the
start of the process). The window then makes calls back to back, each
synchronized at its end, until ``--seconds`` have passed; it ends with
the last call that completed. ``search_positions_per_s`` is the roots of
games still live that its calls searched, over all its seconds.

One call of the window, drawn from the seed as the window runs (each call
kept with chance 1 / its number, so that every call is as likely), keeps
its roots, its tree, its answers and the actions played before it. Once
the window has closed, the peak of device memory has been read and the
program's forward has been freed, :mod:`azbench.check` compares a sample
of its games, drawn from the seed, with the plain reference. A run with
``--trace 1`` runs the same window, then profiles two more plies
(:mod:`azbench.trace`: one with device activity only, one with the host's
too, inside the benchmark's spans ``search``, ``forward`` and ``engine``;
after the window, since a profiler session leaves the process's launches
slower) and reports the per-layer metrics that ``azbench/metrics/`` read
from them and from the window, in place of the end-to-end ones.

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error and the result's
last key. A run without the cards the cell asks for, or with JAX loaded
once the window has closed, prints no result and exits with another code
than 0.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from typing import Callable, Dict, NamedTuple, Optional

from . import guard
from .spec import Cell, load_cell, reader

SEED_STREAMS = ("weights", "play", "keep", "sample", "ply")


def stream(seed: int, name: str) -> int:
    """A seed of its own for each use of the run's seed."""
    return (seed * len(SEED_STREAMS) + SEED_STREAMS.index(name)) % (1 << 63)


class Ply(NamedTuple):
    """One search call: the roots it searched (the program's boards), the
    ply of their game, the program's answers and tree, and the actions
    played before it (ply, games), kept only for the call the check takes."""

    roots: object
    ply: int
    result: object
    tree: object
    actions: object = None


class SelfPlay:
    """The cell's games in lockstep from the opening, one ply a call, as the
    program's self-play plays them (``train/self_play.py::play_games``,
    less its record of the game and its reuse of a child's evaluation as
    the next root's): the program's search of every game, an action drawn
    from the visit counts (at temperature 1 before the traffic's
    ``temperature_threshold`` moves, the most visited after), and the
    program's step of every game still live. When no game is live, new
    games start from the opening."""

    def __init__(self, engine, forward, traffic: Dict, gen, device):
        import torch

        from othello_reinforcement_learning_test_tpu_torch.train.self_play import max_game_length

        self.engine, self.forward, self.traffic = engine, forward, traffic
        self.gen, self.device = gen, device
        self.games = traffic["games"]
        self.actions = torch.zeros((max_game_length(engine.size), self.games), dtype=torch.int64,
                                   device=device)
        self.positions = torch.zeros((), dtype=torch.int64, device=device)  # live roots searched
        self.reset()

    def reset(self) -> None:
        self.boards = self.engine.initial_state((self.games,), device=self.device)
        self.ply_no = 0

    def search(self, net=None, eng=None, sims=None, half=False, noise=None):
        """The program's search of the current roots, tree kept. ``net``,
        ``eng``, ``sims`` and ``noise`` replace the forward, the engine, the
        simulations and the root noise; ``half`` searches the first half of
        the games (the control and the faults)."""
        from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import Board
        from othello_reinforcement_learning_test_tpu_torch.search.mcts import search

        t, b = self.traffic, self.boards
        if half:
            b = Board(*(x[:self.games // 2] for x in b))
        return search(eng or self.engine, net or self.forward, b, sims or t["num_simulations"],
                      c_puct=t["c_puct"], dirichlet_alpha=t["dirichlet_alpha"],
                      dirichlet_epsilon=t["dirichlet_epsilon"],
                      add_noise=t["root_noise"] if noise is None else noise, generator=self.gen,
                      return_tree=True)

    def ply(self, searched: Optional[Callable] = None) -> Ply:
        """Search every game (``searched``: in place of :meth:`search`), play
        the drawn actions, and start new games once every game has ended."""
        import torch

        from othello_reinforcement_learning_test_tpu_torch.search import mcts
        from othello_reinforcement_learning_test_tpu_torch.train.self_play import _sample

        boards, t = self.boards, self.ply_no
        result, tree = (searched or self.search)()
        live = ~result.root_terminal
        temp = torch.where(boards.move_count < self.traffic["temperature_threshold"], 1.0, 0.0)
        action = _sample(mcts.action_probs_from_counts(result.visit_counts, result.legal, temp),
                         self.gen)
        nxt, _ = self.engine.step(boards, action,
                                  pass_legal=result.legal[:, self.engine.pass_action])
        self.boards = type(boards)(*(torch.where(live.view(-1, *[1] * (n.dim() - 1)), n, o)
                                     for n, o in zip(nxt, boards)))
        self.actions[t] = action
        self.positions += live.sum()
        ended = torch.where(live, mcts.extract_root_cache(tree, action).terminal, True)
        self.ply_no = t + 1
        if bool(ended.all()) or self.ply_no == len(self.actions):
            self.reset()
        return Ply(boards, t, result, tree)


class Session(NamedTuple):
    cell: Cell
    sd: Dict  # the weights both sides are handed
    play: SelfPlay
    ply: Callable[[], Ply]  # one ply of the window
    spanned_ply: Callable[[], Ply]  # one ply inside the benchmark's host spans
    phases: Dict  # seconds of each step of the set-up so far


def prepare(cell: Cell, seed: int, device) -> Session:
    """Weights, the program's forward and engine, and its games at the opening."""
    import torch
    from torch.profiler import record_function

    from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import FusedInference
    from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet
    from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import OthelloEngine

    from . import weights

    cfg = cell.config
    phases, t0 = {}, time.perf_counter()

    def phase(name):
        nonlocal t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        phases[name], t0 = time.perf_counter() - t0, time.perf_counter()

    torch.zeros(1, device=device)
    phase("device")
    sd = weights.load(cfg, stream(seed, "weights"), device)
    phase("weights")
    with torch.device("meta"):
        model = OthelloResNet(cfg["num_blocks"], cfg["num_filters"], cfg["board_size"],
                              cfg["value_hidden"])
    model.load_state_dict(sd, assign=True)
    forward = FusedInference(model.eval(), cfg["net_variant"], cfg["activation_scale_block"])
    engine = OthelloEngine(cfg["board_size"], cfg["rules"])
    gen = torch.Generator(device=device)
    gen.manual_seed(stream(seed, "play"))
    play = SelfPlay(engine, forward, cell.traffic, gen, device)
    phase("forward")

    class SpannedEngine:
        """The program's engine with its calls inside the span ``engine``."""

        def __getattr__(self, name):
            return getattr(engine, name)

        def observe(self, *a, **k):
            with record_function("engine"):
                return engine.observe(*a, **k)

        def step(self, *a, **k):
            with record_function("engine"):
                return engine.step(*a, **k)

    def spanned_forward(x):
        with record_function("forward"):
            return forward(x)

    def spanned_ply():
        with record_function("search"):
            return play.ply(lambda: play.search(spanned_forward, SpannedEngine()))

    return Session(cell, sd, play, play.ply, spanned_ply, phases)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(sess: Session, seconds: float, seed: int, device):
    """Plies back to back until ``seconds`` have passed: (calls, live roots
    searched, seconds from the start to the end of the last call, the kept
    call's :class:`Ply` with the actions played before it)."""
    keep_rng = random.Random(stream(seed, "keep"))
    play = sess.play
    calls, kept = 0, None
    first = int(play.positions)
    t0 = time.perf_counter()
    while True:
        out = sess.ply()
        sync(device)
        if keep_rng.random() * (calls + 1) < 1.0:
            kept = out._replace(actions=play.actions[:out.ply].clone())
        calls += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return calls, int(play.positions) - first, elapsed, kept


class Record(NamedTuple):
    """What a per-layer metric's reader is given."""

    config: Dict
    traffic: Dict
    calls: int  # search calls in the window
    positions: int  # live roots those calls searched
    window_s: float
    card: Optional[Dict]  # the card's published peaks, None for a card the table lacks
    device_pass: object  # trace.Pass with device activity only
    host_pass: object  # trace.Pass with the host's activity and spans
    trunk_launches: int  # the trunk wrapper's launch counter over the device pass


def trunk_counter(variant: str):
    """The program's launch counter of the configuration's trunk kernel."""
    import importlib
    module = importlib.import_module(
        f"othello_reinforcement_learning_test_tpu_torch.kernels.trunk_{variant}")
    return getattr(module, f"trunk_{variant}")


def profile(sess: Session):
    """(device pass, host pass, trunk launches in the device pass), each
    pass one ply of the games where the window left them."""
    from . import trace
    wrapper = trunk_counter(sess.cell.config["net_variant"])

    def reset():
        wrapper.launches = 0

    device_pass = trace.traced(sess.ply, host=False, before=reset)
    launches = wrapper.launches
    host_pass = trace.traced(sess.spanned_ply, host=True)
    return device_pass, host_pass, launches


def breakdown(rec: Record) -> Dict:
    """The device operations that took most time, and the idle time by the
    benchmark span the host was in (at most 10 of each)."""
    from . import trace
    by_name: Dict[str, int] = {}
    for op in rec.device_pass.ops:
        by_name[op.name[:120]] = by_name.get(op.name[:120], 0) + op.end_ns - op.start_ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(trace.idle_by_span(rec.host_pass).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v / 1e9] for k, v in top],
            "idle_gaps": [[k, v / 1e9] for k, v in idle]}


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.CalledProcessError, ValueError, IndexError):
        return None


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, started: float) -> Dict:
    """One run of ``cell`` on ``device`` (CPU: the program's plain versions,
    no trace); ``started``: ``time.perf_counter()`` at the process's start."""
    import torch

    from . import check
    from .yardstick import peaks

    t0 = time.perf_counter()
    sess = prepare(cell, seed, device)
    sess.ply()  # builds and warms every kernel and shape of the window
    sess.play.reset()
    sync(device)
    setup_s = time.perf_counter() - started
    phases = dict(start=t0 - started, **sess.phases)
    phases["warm-up ply"] = setup_s - sum(phases.values())

    calls, positions, window_s, kept = window(sess, seconds, seed, device)
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    # after the window: a profiler session leaves the process's launches slower
    passes = profile(sess) if traced else None

    sd, config, traffic = sess.sd, cell.config, cell.traffic
    del sess
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    sample = check.sample_games(traffic["games"], config["activation_scale_block"],
                                traffic["check_blocks"],
                                torch.Generator().manual_seed(stream(seed, "sample")))
    numbers, failed = check.compare(config, traffic, kept, sample, sd, stream(seed, "sample"))
    print("azbench: set-up " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()) + " s",
          file=sys.stderr)
    print(f"azbench: set-up {setup_s:.3f} s, window {window_s:.3f} s of {calls} calls, "
          f"{positions} positions; check of {len(sample)} games at ply {kept.ply} "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    out = {"correct": check.verdict(numbers, config["limits"]),
           "attempted": positions, "failed": int(failed.sum())}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(peak), "power_limit_w": power_limit_w() if on_card else None}
    if traced:
        from . import trace
        rec = Record(config, traffic, calls, positions, window_s, peaks(kind), *passes)
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = trace.busy_ns(rec.device_pass.ops, rec.device_pass.window) / 1e9
        dev["window_s"] = (rec.device_pass.window[1] - rec.device_pass.window[0]) / 1e9
        out.update(metrics=metrics, device=dev, breakdown=breakdown(rec))
    else:
        values = {"search_positions_per_s": positions / window_s, "setup_s": setup_s}
        out.update(metrics={m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                            for m in cell.end_to_end}, device=dev)
    out["checks"] = {k: {"value": numbers[k], "limit": config["limits"][k]}
                     for k in check.NUMBERS}
    return out


def main(argv=None, started: Optional[float] = None) -> int:
    started = time.perf_counter() if started is None else started
    parser = argparse.ArgumentParser(prog="python3 -m azbench", description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        cell = load_cell(args.workload)
    except (KeyError, OSError) as e:
        print(f"azbench: no cell {args.workload!r} ({e!r})", file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"azbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), started)
    found = guard.loaded(sys.modules)
    if found:
        print(f"azbench: JAX modules loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
