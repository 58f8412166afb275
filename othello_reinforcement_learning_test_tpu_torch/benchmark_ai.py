"""AI strength benchmark: a checkpoint against Random and Greedy.

    python -m othello_reinforcement_learning_test_tpu_torch.benchmark_ai --checkpoint data/models/final_model.pt

Port of the root ``benchmark_ai.py`` (which stays JAX-only): the same
flags, rows and JSON artifact keys, with ``--device {auto,cpu}`` (``auto``
is CUDA, required) in place of ``--platform``. Every game of a match runs
batched in one arena. Two rows per opponent: the headline row with the
first ``--opening-random-plies`` plies random (diverse games), and unless
skipped the deterministic row (which quantizes the win rates of
deterministic pairs to 0, 50 or 100%).
"""

from __future__ import annotations

import argparse
import json
import os
from datetime import datetime
from typing import Optional

import torch

from .cli import draw_seed
from .evaluation import Arena, GreedyPlayer, MCTSPlayer, RandomPlayer
from .utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--games", type=int, default=50)
    parser.add_argument("--simulations", type=int, default=100)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output-dir", default="data/benchmark")
    parser.add_argument("--opening-random-plies", type=int, default=4,
                        help="randomize first k plies for the headline row "
                             "(deterministic pairs quantize win rates to "
                             "{0,50,100}%%)")
    parser.add_argument("--skip-deterministic", action="store_true",
                        help="omit the reference-faithful deterministic row")
    parser.add_argument("--device", choices=["auto", "cpu"], default="auto",
                        help="auto = CUDA (required); cpu = the CPU")
    return parser


def main(argv: Optional[list] = None) -> str:
    """Run the benchmark; returns the report's path."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    player = MCTSPlayer.from_checkpoint(args.checkpoint, num_simulations=args.simulations,
                                        device=device)
    engine = player.engine
    arena = Arena(engine, verbose=True, device=device)
    rng = torch.Generator().manual_seed(args.seed)

    report = {
        "checkpoint": args.checkpoint,
        "timestamp": datetime.now().isoformat(),
        "simulations": args.simulations,
        "games_per_opponent": args.games,
        "opening_random_plies": args.opening_random_plies,
        "results": {},
        "deterministic_results": {},
    }
    regimes = [("results", args.opening_random_plies)]
    if not args.skip_deterministic and args.opening_random_plies != 0:
        regimes.append(("deterministic_results", 0))
    for opponent in (RandomPlayer(engine), GreedyPlayer(engine)):
        for key, plies in regimes:
            seed = draw_seed(rng)
            s = arena.play_matches(player, opponent, args.games, seed,
                                   opening_random_plies=plies)
            scores = [r.player1_score for r in s.results]
            report[key][opponent.name] = {
                "wins": s.wins,
                "losses": s.losses,
                "draws": s.draws,
                "win_rate": s.win_rate,
                "avg_score": s.avg_score,
                "score_min": min(scores),
                "score_max": max(scores),
                "avg_moves": s.avg_moves,
            }

    os.makedirs(args.output_dir, exist_ok=True)
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    path = os.path.join(args.output_dir, f"benchmark_{stamp}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"\nreport saved to {path}")
    return path


if __name__ == "__main__":
    main()
