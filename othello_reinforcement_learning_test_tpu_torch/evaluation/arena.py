"""Batched evaluation arena.

Port of ``othello_reinforcement_learning_test_tpu/evaluation/arena.py``: all
N games of a match run in lockstep, colours alternating by game index
(player 1 is black in even games). Both players act on every board at every
step and the mover's action is picked by parity; finished games are frozen.
The JAX package's jitted ``while_loop`` is a host loop over plies here, with
the same cap (``max_game_length``). The JAX ``mesh`` is ``shard=(rank,
world)``: each rank plays its slice of the match's games, with every random
draw (the players' and the openings') taken at the match's shape and
sliced, and the per-game outcomes are all-gathered in game order, so every
rank builds the same summary and a gate makes the same decision.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.bitboard import OthelloEngine
from ..parallel.mesh import all_gather_leading, shard_rows
from ..train.self_play import max_game_length
from ..utils import profiling
from ..utils.device import resolve_device
from .players import Player, uniform_legal


@dataclass
class MatchResult:
    """One game's record."""

    player1: str
    player2: str
    winner: int  # 1 = player1, -1 = player2, 0 = draw
    player1_score: int
    player2_score: int
    num_moves: int
    duration: float
    player1_color: str  # "black" | "white"


@dataclass
class MatchSummary:
    player1: str
    player2: str
    wins: int
    losses: int
    draws: int
    win_rate: float
    avg_score: float
    avg_moves: float
    duration: float
    results: List[MatchResult] = field(default_factory=list)


class Arena:
    """Plays batched matches between two players on ``device`` (CUDA unless
    ``"cpu"`` is asked for); with ``shard=(rank, world)`` this rank plays
    its slice of each match (see the module docstring)."""

    def __init__(self, engine: OthelloEngine, verbose: bool = False, device=None,
                 shard: Optional[Tuple[int, int]] = None):
        self.engine = engine
        self.verbose = verbose
        self.device = resolve_device(device)
        self.shard = shard

    @torch.no_grad()
    def play_matches(self, player1: Player, player2: Player, num_games: int, seed: int = 0,
                     opening_random_plies: int = 0) -> MatchSummary:
        """Play ``num_games`` games; ``seed`` seeds the generator that both
        players and the openings draw from. ``opening_random_plies`` > 0
        plays the first k plies uniformly at random over the legal moves,
        for both sides, so that deterministic pairs (temperature-0 MCTS
        against Greedy) play diverse games instead of one game per
        colour. Each ply's liveness test is a host sync, the span
        ``sync.live`` while tracing."""
        eng, dev = self.engine, self.device
        t0 = time.time()
        gen = torch.Generator(device=dev).manual_seed(seed)
        rows = shard_rows(num_games, self.shard)
        games = torch.arange(num_games, device=dev)[rows[1] if rows else slice(None)]
        boards = eng.initial_state((games.shape[0],), device=dev)
        p1_black = games % 2 == 0
        for _ in range(max_game_length(eng.size)):
            live = ~eng.is_terminal(boards)
            if not profiling.host_bool(live.any(), "sync.live"):
                break
            # a player's rows only in a sharded match: players written for
            # whole matches keep act(boards, generator)
            extra = () if rows is None else (rows,)
            a1 = player1.act(boards, gen, *extra)
            a2 = player2.act(boards, gen, *extra)
            p1_to_move = (boards.move_count % 2 == 0) == p1_black
            action = torch.where(p1_to_move, a1, a2)
            if opening_random_plies > 0:
                action = torch.where(boards.move_count < opening_random_plies,
                                     uniform_legal(eng, boards, gen, rows), action)
            nxt, _ = eng.step(boards, action)
            boards = type(boards)(*(torch.where(live, n, o) for n, o in zip(nxt, boards)))

        # winner and scores from the final side to move
        w_mover = eng.winner(boards)
        black_to_move = boards.move_count % 2 == 0
        w_black = torch.where(black_to_move, w_mover, -w_mover)
        w_p1 = torch.where(p1_black, w_black, -w_black)
        c_me, c_opp = eng.stone_counts(boards)
        black = torch.where(black_to_move, c_me, c_opp)
        white = torch.where(black_to_move, c_opp, c_me)
        p1_score = torch.where(p1_black, black, white)
        p2_score = torch.where(p1_black, white, black)
        outcome = (w_p1, p1_score, p2_score, boards.move_count)
        if rows is not None:
            outcome = all_gather_leading(outcome)
        w_p1, p1_score, p2_score, moves = (t.cpu().numpy() for t in outcome)
        duration = time.time() - t0

        results = [MatchResult(player1=player1.name, player2=player2.name, winner=int(w_p1[i]),
                               player1_score=int(p1_score[i]), player2_score=int(p2_score[i]),
                               num_moves=int(moves[i]), duration=duration / num_games,
                               player1_color="black" if i % 2 == 0 else "white")
                   for i in range(num_games)]
        wins = int((w_p1 == 1).sum())
        summary = MatchSummary(
            player1=player1.name, player2=player2.name, wins=wins,
            losses=int((w_p1 == -1).sum()), draws=int((w_p1 == 0).sum()),
            win_rate=wins / num_games, avg_score=float(np.mean(p1_score)),
            avg_moves=float(np.mean(moves)), duration=duration, results=results)
        if self.verbose:
            self._print_summary(summary)
        return summary

    def play_game(self, player1: Player, player2: Player, seed: int = 0,
                  player1_color: str = "black") -> MatchResult:
        """One game through the batched path. Game 0 seats the first player
        as black, so for white the players swap seats and the result is
        re-expressed from player 1's side."""
        if player1_color == "white":
            r = self.play_matches(player2, player1, 1, seed).results[0]
            return MatchResult(player1=player1.name, player2=player2.name, winner=-r.winner,
                               player1_score=r.player2_score, player2_score=r.player1_score,
                               num_moves=r.num_moves, duration=r.duration,
                               player1_color="white")
        return self.play_matches(player1, player2, 1, seed).results[0]

    @staticmethod
    def _print_summary(s: MatchSummary) -> None:
        print(f"{s.player1} vs {s.player2}: {s.wins}W-{s.losses}L-{s.draws}D "
              f"({s.win_rate:.1%}), avg score {s.avg_score:.1f}, "
              f"avg moves {s.avg_moves:.1f}, {s.duration:.1f}s")


def evaluate_player(player: Player, opponent: Player, engine: OthelloEngine,
                    num_games: int = 20, seed: Optional[int] = None, verbose: bool = False,
                    opening_random_plies: int = 0, device=None) -> Dict:
    """A match, returned as the reference's ``evaluate_player`` dict."""
    s = Arena(engine, verbose=verbose, device=device).play_matches(
        player, opponent, num_games, 0 if seed is None else seed,
        opening_random_plies=opening_random_plies)
    return {"opponent": opponent.name, "num_games": num_games, "wins": s.wins,
            "losses": s.losses, "draws": s.draws, "win_rate": s.win_rate,
            "avg_score": s.avg_score, "avg_moves": s.avg_moves, "results": s.results}
