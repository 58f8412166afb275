"""Learning curve: every checkpoint in a directory against the baselines.

    python -m othello_reinforcement_learning_test_tpu_torch.learning_curve --checkpoint-dir data/models

Port of the root ``learning_curve.py`` (which stays JAX-only): the same
flags, table and curve JSON keys. The checkpoints are the port's
``checkpoint_iter_<N>.pt`` files (the JAX script reads orbax directories of
that name). Each is played against Random and Greedy, and optionally a
fixed ``--anchor-checkpoint`` and the native alpha-beta engine at
``--minimax-depth``. ``--device auto`` is CUDA (required), ``cpu`` the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from datetime import datetime
from typing import Optional

import torch

from .cli import draw_seed
from .evaluation import GreedyPlayer, MCTSPlayer, NativeMinimaxPlayer, RandomPlayer, evaluate_player
from .utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--games", type=int, default=32)
    parser.add_argument("--simulations", type=int, default=50)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", choices=["auto", "cpu"], default="auto",
                        help="auto = CUDA (required); cpu = the CPU")
    parser.add_argument("--anchor-checkpoint", default=None,
                        help="also evaluate every checkpoint against this "
                             "fixed MCTS checkpoint (strength anchor)")
    parser.add_argument("--minimax-depth", type=int, default=0,
                        help="also evaluate vs the native C++ alpha-beta "
                             "anchor at this depth (0 = off)")
    parser.add_argument("--opening-random-plies", type=int, default=4,
                        help="randomize the first k plies so deterministic "
                             "player pairs produce diverse games")
    parser.add_argument("--output", default=None)
    return parser


def main(argv: Optional[list] = None) -> str:
    """Evaluate the directory's checkpoints; returns the curve's path."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ckpts = []
    for e in sorted(os.listdir(args.checkpoint_dir)):
        path = os.path.join(args.checkpoint_dir, e)
        m = re.fullmatch(r"checkpoint_iter_(\d+)\.pt", e)
        if m and os.path.isfile(path):
            ckpts.append((int(m.group(1)), path))
    if not ckpts:
        raise SystemExit(f"no checkpoints under {args.checkpoint_dir}")

    curve = []
    rng = torch.Generator().manual_seed(args.seed)
    anchor = None
    if args.anchor_checkpoint:
        anchor = MCTSPlayer.from_checkpoint(args.anchor_checkpoint,
                                            num_simulations=args.simulations, device=device)
        anchor.name = "Anchor"
    minimax = None
    header = f"{'iter':>6} {'vs Random':>10} {'vs Greedy':>10}"
    if anchor:
        header += f" {'vs Anchor':>10}"
    if args.minimax_depth:
        header += f" {'vs Minimax':>10}"
    print(header)
    player = None
    for iteration, path in ckpts:
        player = MCTSPlayer.from_checkpoint(
            path, num_simulations=args.simulations,
            engine=None if player is None else player.engine, device=device)
        engine = player.engine
        row = {"iteration": iteration, "checkpoint": path}
        opponents = [(RandomPlayer(engine), "random"), (GreedyPlayer(engine), "greedy")]
        if anchor is not None:
            opponents.append((anchor, "anchor"))
        if args.minimax_depth:
            if minimax is None:
                minimax = NativeMinimaxPlayer(engine, depth=args.minimax_depth)
            opponents.append((minimax, "minimax"))
        for opponent, name in opponents:
            seed = draw_seed(rng)
            out = evaluate_player(player, opponent, engine, num_games=args.games, seed=seed,
                                  opening_random_plies=args.opening_random_plies,
                                  device=device)
            row[f"win_rate_vs_{name}"] = out["win_rate"]
            row[f"avg_score_vs_{name}"] = out["avg_score"]
        curve.append(row)
        line = (f"{iteration:>6} {row['win_rate_vs_random']:>9.1%} "
                f"{row['win_rate_vs_greedy']:>9.1%}")
        if anchor is not None:
            line += f" {row['win_rate_vs_anchor']:>9.1%}"
        if args.minimax_depth:
            line += f" {row['win_rate_vs_minimax']:>9.1%}"
        print(line)

    out_path = args.output or os.path.join(
        args.checkpoint_dir,
        f"learning_curve_{datetime.now().strftime('%Y%m%d_%H%M%S')}.json")
    with open(out_path, "w") as f:
        json.dump({"checkpoint_dir": args.checkpoint_dir, "games": args.games,
                   "simulations": args.simulations, "curve": curve}, f, indent=2)
    print(f"curve saved to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
