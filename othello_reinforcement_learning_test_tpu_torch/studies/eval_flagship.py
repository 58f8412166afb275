"""A flagship network against a fixed list of opponents, one JSON line a
matchup.

    python -m othello_reinforcement_learning_test_tpu_torch.studies.eval_flagship \\
        --preset r4|r5_ext --ckpt FILE.pt [--games N] [--sims 100] \\
        [--networks DIR] [--device cpu]

Port of the JAX package's ``scripts/eval_flagship_r4.py`` and
``eval_flagship_r5_ext.py`` (which stay JAX-only), one preset each; they
differ only in their opponents, seeds and lines. The protocol is the
ladder's: ``--sims`` simulations, 4 random opening plies, colours
alternating, the ``--ckpt`` network as player 1.

- ``r4``: against net-500iter, net-600iter-gated, net-strong500, Greedy and
  Random, match i at seed 100 + i; networks play ``--games`` (default 200)
  games, the baselines 100; lines ``{opponent, wins, losses, draws,
  decisive_win_rate}``.
- ``r5_ext``: against net-flagship-r5 and net-flagship-r4, match i at seed
  500 + i, ``--games`` (default 300) each; lines ``{opponent, wins, losses,
  draws, decisive_winrate, games}``.

``--ckpt`` is a ``.pt`` file (``scripts/orbax_to_torch.py`` makes one from
a JAX checkpoint). The JAX scripts' default checkpoints are not in the
repo, so without ``--ckpt`` the module raises, naming the command that
converts the preset's. Opponents resolve as the ladder's networks do
(``trained/``, then ``--networks``); ``--device`` is CUDA unless ``cpu`` is
asked for, with no fallback.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from ..evaluation.arena import Arena, MatchSummary
from ..evaluation.players import MCTSPlayer
from ..ops.bitboard import get_engine
from ..utils.device import resolve_device
from .common import OPENING_RANDOM_PLIES, make_player, network_path
from .elo_ladder import CHECKPOINTS, MINIMAX

PRESETS = {
    "r4": {"ckpt": "data/models/tpu9_flagship_r4/final_model", "games": 200, "seed": 100,
           "opponents": ("net-500iter", "net-600iter-gated", "net-strong500", "greedy",
                         "random")},
    "r5_ext": {"ckpt": "data/models/tpu13_flagship_r5_ext2/final_model", "games": 300,
               "seed": 500, "opponents": ("net-flagship-r5", "net-flagship-r4")},
}
BASELINE_GAMES = 100  # r4's games against a baseline (a non-network opponent)


def line(preset: str, opponent: str, s: MatchSummary) -> Dict:
    """The JAX script's JSON line for one matchup."""
    row = {"opponent": opponent, "wins": s.wins, "losses": s.losses, "draws": s.draws}
    if preset == "r4":
        row["decisive_win_rate"] = round(s.wins / max(s.wins + s.losses, 1), 4)
    else:
        dec = s.wins + s.losses
        row["decisive_winrate"] = round(s.wins / dec if dec else 0.0, 4)
        row["games"] = s.wins + s.losses + s.draws
    return row


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), required=True)
    ap.add_argument("--ckpt", default=None, help="the network to evaluate, a .pt file")
    ap.add_argument("--games", type=int, default=None,
                    help="games against a network (default: 200 for r4, 300 for r5_ext)")
    ap.add_argument("--sims", type=int, default=100)
    ap.add_argument("--networks", default=None,
                    help="directory of .pt files for opponents not shipped in trained/")
    ap.add_argument("--device", default=None, help="torch device: CUDA unless 'cpu' is asked for")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    preset = PRESETS[args.preset]
    games = preset["games"] if args.games is None else args.games
    ckpt = args.ckpt or network_path(f"--ckpt of preset {args.preset}", preset["ckpt"])
    device = resolve_device(args.device)
    eng = get_engine(8, "reference")
    new = MCTSPlayer.from_checkpoint(ckpt, engine=eng, num_simulations=args.sims, device=device)
    arena = Arena(eng, device=device)
    opponents = [(name, make_player(name, eng, CHECKPOINTS, MINIMAX, args.networks, args.sims,
                                    device))
                 for name in preset["opponents"]]
    for i, (name, opp) in enumerate(opponents):
        n = games if args.preset == "r5_ext" or name.startswith("net") else BASELINE_GAMES
        s = arena.play_matches(new, opp, n, preset["seed"] + i,
                               opening_random_plies=OPENING_RANDOM_PLIES)
        print(json.dumps(line(args.preset, name, s)), flush=True)


if __name__ == "__main__":
    main()
