from .arena import Arena, MatchResult, MatchSummary, evaluate_player
from .players import (
    EdaxPlayer,
    GreedyPlayer,
    HumanPlayer,
    MCTSPlayer,
    NativeMinimaxPlayer,
    Player,
    RandomPlayer,
)

__all__ = [
    "Arena",
    "EdaxPlayer",
    "GreedyPlayer",
    "HumanPlayer",
    "MCTSPlayer",
    "MatchResult",
    "MatchSummary",
    "NativeMinimaxPlayer",
    "Player",
    "RandomPlayer",
    "evaluate_player",
]
