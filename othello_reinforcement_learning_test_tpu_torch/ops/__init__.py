from . import bits
from .bitboard import Board, OthelloEngine, get_engine

__all__ = ["bits", "Board", "OthelloEngine", "get_engine"]
