"""Per-ply glue of the self-play loop, part by part, on one device.

    python -m othello_reinforcement_learning_test_tpu_torch.profilers.profile_move_glue \\
        [--batch 1024] [--reps 200] [--device cpu]

Port of the JAX package's ``scripts/profile_move_glue.py`` (which stays
JAX-only): the same flags and defaults, with ``--device`` (CUDA unless
``cpu`` is asked for; no fallback) in place of ``--platform``.
``profile_mcts_parts`` covers a simulation and ``profile_forward_parts``
the forward; this covers what ``train/self_play.py::play_games`` runs once
a ply around the search, each part timed with ``profilers/common.py``'s
harness at B games in the initial position:

- root Dirichlet noise, ``mcts.add_dirichlet_noise`` (gamma draws);
- the two ``action_probs_from_counts`` calls (the pi target and the
  temperature schedule's action distribution);
- the Gumbel-max draw, ``self_play._sample``;
- the five trajectory writes;
- ``engine.step`` + the ``_keep`` blend of the boards and the root cache;
- the ply loop's liveness test, one host sync.

Parts that draw restore the generator and parts that write restore their
buffers before each call, outside the timed window. Then it plays
``play_games`` with the JAX script's cheap settings (a 1x8 network, 2
simulations, ``temperature_threshold=15``) and reports the lockstep game
lengths: the mean, the max P (the plies the lockstep loop runs) and the
tail factor P / mean. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch

from ..ops.bitboard import Board, get_engine
from ..search import mcts
from ..train.self_play import _keep, _sample, max_game_length, play_games
from ..train.trainer import apply_eval
from ..utils.device import resolve_device
from .common import Harness, device_record, finish, initial_model
from .profile_mcts import constant_net

ALPHA, EPS = 0.3, 0.25
TEMPERATURE_THRESHOLD = 15


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=200, help="calls a repeat")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default=None, help="torch device: CUDA unless 'cpu' is asked for")
    return ap.parse_args(argv)


def glue_parts(engine, B: int, dev: torch.device) -> Dict[str, tuple]:
    """The ply's glue at B games in the initial position: {name: (part,
    restore or None)}. Counts are uniform draws on the legal actions times
    20, as in the JAX script; the root cache and the tree come from a
    2-simulation search through a constant network, and the step plays
    its best action, whose child that search expanded."""
    gen = torch.Generator(device=dev).manual_seed(3)
    gen_state = gen.get_state()
    boards = engine.initial_state((B,), device=dev)
    legal, term, win, _ = engine.observe(boards, with_features=True)
    counts = torch.rand(legal.shape, generator=gen, device=dev) * legal * 20
    prior = mcts.masked_probs(torch.log(counts + 1e-9), legal)
    win = win.to(torch.float32)
    cache = mcts.RootCache(prior=prior, value=torch.zeros_like(win), legal=legal,
                           terminal=term, winner=win)
    res, tree = mcts.search(engine, constant_net(engine.num_actions, dev), boards, 2,
                            root_cache=cache, return_tree=True)
    action = mcts.best_action(res.visit_counts, res.legal)
    live = ~cache.terminal
    T = max_game_length(engine.size)
    t_me = torch.zeros((B, T), dtype=torch.int64, device=dev)
    t_opp = torch.zeros_like(t_me)
    t_pi = torch.zeros((B, T, engine.num_actions), dtype=torch.float32, device=dev)
    t_par = torch.zeros((B, T), dtype=torch.int32, device=dev)
    t_mask = torch.zeros((B, T), dtype=torch.bool, device=dev)
    trajectory = (t_me, t_opp, t_pi, t_par, t_mask)

    def redraw():
        gen.set_state(gen_state)

    def probs2():
        pi = mcts.action_probs_from_counts(counts, legal, 1.0)
        temp = torch.where(boards.move_count < TEMPERATURE_THRESHOLD, 1.0, 0.0)
        return pi, mcts.action_probs_from_counts(counts, legal, temp)

    pi, probs = probs2()

    def writes(t: int = 0):
        t_me[:, t] = torch.where(live, boards.me, 0)
        t_opp[:, t] = torch.where(live, boards.opp, 0)
        t_pi[:, t] = torch.where(live[:, None], pi, 0.0)
        t_par[:, t] = torch.where(live, boards.move_count % 2, 0)
        t_mask[:, t] = live
        return trajectory

    def step():
        nxt, _ = engine.step(boards, action, pass_legal=res.legal[:, engine.pass_action])
        after = Board(*(_keep(live, n, o) for n, o in zip(nxt, boards)))
        return after, mcts.RootCache(*(_keep(live, n, o) for n, o in
                                       zip(mcts.extract_root_cache(tree, action), cache)))

    return {
        "dirichlet noise (gamma B*A)": (
            lambda: mcts.add_dirichlet_noise(gen, prior, legal, ALPHA, EPS), redraw),
        "action_probs x2": (probs2, None),
        "categorical sample (Gumbel-max)": (lambda: _sample(probs, gen), redraw),
        "trajectory writes x5": (writes, lambda: [buf.zero_() for buf in trajectory]),
        "engine.step + blend": (step, None),
        "liveness sync": (lambda: bool((~cache.terminal).any()), None),
    }


@torch.no_grad()
def run(argv: Optional[List[str]] = None) -> Dict:
    """Print the rows and return the JSON object."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    B = args.batch
    engine = get_engine(8)
    h = Harness(dev, args.reps, args.repeats, unit="us")
    h.null()
    rows = [h.time(name, part, restore=restore)
            for name, (part, restore) in glue_parts(engine, B, dev).items()]
    total = sum(r["wall_ms_net"]["best"] for r in rows)
    print(f"{'sum of move glue':34s}: {total * 1e3:9.1f} us/ply")

    traj = play_games(engine, apply_eval(initial_model(1, 8, dev)), B, 2,
                      temperature_threshold=TEMPERATURE_THRESHOLD, seed=5, device=dev)
    moves = traj.num_moves.to(torch.float32).cpu()
    mean, longest = float(moves.mean()), int(moves.max())
    print(f"game lengths at B={B}: mean {mean:.1f}, max (lockstep P) {longest}, "
          f"tail factor {longest / mean:.3f}")
    return {"profiler": "profile_move_glue", "batch": B, "reps": args.reps,
            "repeats": args.repeats, **device_record(dev), "rows": h.rows,
            "sum_of_glue_ms": total,
            "game_lengths": {"mean": mean, "max": longest, "tail_factor": longest / mean}}


def main(argv: Optional[List[str]] = None) -> int:
    return finish(run(argv))


if __name__ == "__main__":
    sys.exit(main())
