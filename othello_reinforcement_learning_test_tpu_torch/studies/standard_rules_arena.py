"""A round robin under ``game.rules: standard`` for the symmetry-augmentation
pair.

    python -m othello_reinforcement_learning_test_tpu_torch.studies.standard_rules_arena \\
        [--phase tpu|cpu] [--games 120] [--connect-games 24] \\
        [--out _build/studies/symmetry_ablation.json] [--networks DIR] [--device cpu]

Port of the JAX package's ``scripts/standard_rules_arena.py`` (which stays
JAX-only). Symmetry augmentation is sound only under D4-symmetric rules, so
the ablation pair (``configs/run_500iter_symbase.yaml`` and
``run_500iter_symaug.yaml``, identical but for ``augment_symmetries``)
plays in an arena of its own under the standard rules, with the protocol of
the Elo ladder (``studies/elo_ladder.py``). The two ``--phase`` values are
the names of its pair sets and pick no device:

- ``tpu``: ``sym-aug|sym-base``, then each network against Random and
  Greedy, all at ``--games``;
- ``cpu``: each network against minimax d2, d4 and d6 at
  ``--connect-games``.

Pairs merge into ``--out`` (default the git-ignored
``_build/studies/symmetry_ablation.json``; the repo's record stays
``results/symmetry_ablation.json``), whose rows carry no protocol block, as
the JAX record's do not. Networks come from ``trained/`` or ``--networks``;
``--device`` is CUDA unless ``cpu`` is asked for, with no fallback.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from ..ops.bitboard import get_engine
from ..utils.device import resolve_device
from .common import OUT_DIR, play_pairs

CHECKPOINTS = {
    "sym-base": "results/model_10x128_500iter_symbase",
    "sym-aug": "results/model_10x128_500iter_symaug",
}
MINIMAX = {"minimax-d2": 2, "minimax-d4": 4, "minimax-d6": 6}
SIMS = 100
OUT = OUT_DIR / "symmetry_ablation.json"


def play(pairs, games: int, out_path: str, networks: Optional[str] = None, device=None,
         sims: int = SIMS) -> Dict:
    """Play ``pairs`` under the standard rules into ``out_path``."""
    return play_pairs(pairs, games, out_path, get_engine(8, "standard"), CHECKPOINTS, MINIMAX,
                      networks, sims, device, protocol=None)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=["tpu", "cpu"], default=None,
                    help="the pair set to play (a name, not a device)")
    ap.add_argument("--games", type=int, default=120,
                    help="head-to-head games (anchor pairs use --games too)")
    ap.add_argument("--connect-games", type=int, default=24)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--networks", default=None,
                    help="directory of .pt files for networks not shipped in trained/")
    ap.add_argument("--device", default=None, help="torch device: CUDA unless 'cpu' is asked for")
    return ap.parse_args(argv)


def pair_sets(phase: str, games: int, connect_games: int) -> List[tuple]:
    """[(pairs, games)] that ``--phase`` plays."""
    if phase == "tpu":
        pairs = [("sym-aug", "sym-base")]
        pairs += [(n, a) for n in CHECKPOINTS for a in ("random", "greedy")]
        return [(pairs, games)]
    return [([(n, m) for n in CHECKPOINTS for m in MINIMAX], connect_games)]


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.phase:
        device = resolve_device(args.device)
        for pairs, games in pair_sets(args.phase, args.games, args.connect_games):
            play(pairs, games, args.out, args.networks, device)


if __name__ == "__main__":
    main()
