"""ctypes binding of the repository's C++ host engine, ``csrc/othello_native.cpp``.

The port's own copy of the JAX package's ``ops/native.py`` (that module
cannot be imported without JAX): :func:`best_move`, the alpha-beta search
behind ``NativeMinimaxPlayer``; :func:`legal` and :func:`flips` for checks
against the tensor engine; :func:`available`; :class:`NativeBoard`, a
single-game board with the reference ``OthelloBitboard`` API; and
:func:`random_playout_benchmark`, the engine benchmark's workload. 8x8
only: the engine works on one 64-bit word per side.

The shared library is compiled with ``g++`` on first use into the package's
git-ignored ``_build/`` directory (never into ``csrc/``); its file name
carries a hash of the source and the flags, so an edited source is rebuilt.
A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "othello_native.cpp"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
RULES = {"reference": 0, "standard": 1}


def build() -> Path:
    """Compile the engine unless a library for this source and these flags
    exists; returns its path."""
    if not SOURCE.is_file():
        raise RuntimeError(f"the native engine's source {SOURCE} is missing")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libothello_native-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) for {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never sees a partial file
    return out


@functools.cache
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    u64, i32, i64 = ctypes.c_uint64, ctypes.c_int, ctypes.c_longlong
    lib.oth_legal.restype = u64
    lib.oth_legal.argtypes = [u64, u64, i32]
    lib.oth_flips.restype = u64
    lib.oth_flips.argtypes = [u64, u64, i32, i32]
    lib.oth_popcount.restype = i32
    lib.oth_popcount.argtypes = [u64]
    lib.oth_step.restype = i32
    lib.oth_step.argtypes = [ctypes.POINTER(u64), i32, i32]
    lib.oth_is_terminal.restype = i32
    lib.oth_is_terminal.argtypes = [u64, u64, i32]
    lib.oth_random_playouts.restype = i64
    lib.oth_random_playouts.argtypes = [i64, u64, i32, ctypes.POINTER(i64),
                                        ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.oth_best_move.restype = i32
    lib.oth_best_move.argtypes = [u64, u64, i32, i32, i32, ctypes.POINTER(i32)]
    return lib


def best_move(me: int, opp: int, depth: int = 6, exact_empties: int = 12,
              rules: str = "reference") -> Tuple[int, int]:
    """Alpha-beta best action for the side to move: ``(action, negamax
    score)``; action 64 is the pass. Positions with at most
    ``exact_empties`` empty squares are solved exactly by disc difference.
    ``me`` and ``opp`` are unsigned 64-bit words."""
    score = ctypes.c_int()
    action = load().oth_best_move(me, opp, int(depth), int(exact_empties), RULES[rules],
                                  ctypes.byref(score))
    return int(action), int(score.value)


def legal(me: int, opp: int, rules: str = "reference") -> int:
    """Bitmask of the side to move's legal squares."""
    return int(load().oth_legal(me, opp, RULES[rules]))


def flips(me: int, opp: int, pos: int, rules: str = "reference") -> int:
    """Stones flipped by placing on square ``pos`` (0 if illegal there)."""
    return int(load().oth_flips(me, opp, int(pos), RULES[rules]))


def available() -> bool:
    """Whether the engine builds and loads (it needs ``g++``)."""
    try:
        load()
        return True
    except Exception:  # noqa: BLE001 — no compiler / load failure
        return False


class NativeBoard:
    """Host-side single-game board with the reference ``OthelloBitboard``
    API: reset / get_legal_moves / get_legal_moves_bits / make_move /
    is_terminal / get_winner / get_stone_counts / get_tensor_input / copy /
    get_symmetries / to_string. 8x8 only."""

    def __init__(self, rules: str = "reference"):
        self._lib = load()
        self._rules = RULES[rules]
        self.rules = rules
        self.reset()

    def reset(self) -> None:
        self.self_board = (1 << 28) | (1 << 35)
        self.opp_board = (1 << 27) | (1 << 36)
        self.move_count = 0
        self.passed = False

    def get_legal_moves_bits(self) -> int:
        return int(self._lib.oth_legal(self.self_board, self.opp_board, self._rules))

    def get_legal_moves(self) -> List[int]:
        bits_ = self.get_legal_moves_bits()
        if bits_ == 0:
            return [64]
        return [i for i in range(64) if bits_ >> i & 1]

    def make_move(self, pos: int) -> bool:
        """Play square ``pos`` (64 passes); False, and no change, when it
        is not legal."""
        if pos != 64 and not 0 <= pos <= 63:
            return False
        boards = (ctypes.c_uint64 * 2)(self.self_board, self.opp_board)
        ok = self._lib.oth_step(boards, pos, self._rules)
        if ok:
            self.self_board, self.opp_board = boards[0], boards[1]
            self.move_count += 1
            self.passed = pos == 64
        return bool(ok)

    def is_terminal(self) -> bool:
        return bool(self._lib.oth_is_terminal(self.self_board, self.opp_board, self._rules))

    def get_winner(self) -> int:
        a, b = self.get_stone_counts()
        return (a > b) - (a < b)

    def get_stone_counts(self) -> Tuple[int, int]:
        return (int(self._lib.oth_popcount(self.self_board)),
                int(self._lib.oth_popcount(self.opp_board)))

    def get_tensor_input(self) -> np.ndarray:
        """(8, 8, 3) float32 NHWC: own / opponent / legal."""
        words = np.array([self.self_board, self.opp_board, self.get_legal_moves_bits()],
                         np.uint64)
        planes = (words[:, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
        return np.ascontiguousarray(planes.astype(np.float32).reshape(3, 8, 8).transpose(1, 2, 0))

    def copy(self) -> "NativeBoard":
        nb = NativeBoard.__new__(NativeBoard)
        nb.__dict__.update(self.__dict__)
        return nb

    def get_symmetries(self, pi: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The 8 D4-symmetric (tensor, pi) pairs in the reference's order:
        for k in 0..3, rot90(k), then rot90(k) flipped left-right."""
        board = self.get_tensor_input()
        pi_grid = np.asarray(pi[:64], np.float32).reshape(8, 8)
        out = []
        for k in range(4):
            rb = np.rot90(board, k, axes=(0, 1))
            rp = np.rot90(pi_grid, k)
            for flip in (False, True):
                b2 = np.flip(rb, axis=1) if flip else rb
                p2 = np.flip(rp, axis=1) if flip else rp
                new_pi = np.zeros(65, np.float32)
                new_pi[:64] = p2.reshape(-1)
                new_pi[64] = pi[64]
                out.append((b2.copy(), new_pi))
        return out

    def to_string(self) -> str:
        lines = ["  A B C D E F G H"]
        for r in range(8):
            row = [f"{r + 1} "]
            for c in range(8):
                i = r * 8 + c
                row.append("● " if self.self_board >> i & 1
                           else "○ " if self.opp_board >> i & 1 else ". ")
            lines.append("".join(row).rstrip())
        return "\n".join(lines)

    __repr__ = to_string


def random_playout_benchmark(n_games: int, seed: int = 1, rules: str = "reference") -> dict:
    """Random-vs-random playouts on the C++ engine, one host core: counts
    and throughput."""
    lib = load()
    bw, ww, dr = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_longlong()
    t0 = time.perf_counter()
    moves = lib.oth_random_playouts(n_games, seed, RULES[rules], ctypes.byref(bw),
                                    ctypes.byref(ww), ctypes.byref(dr))
    dt = time.perf_counter() - t0
    return {
        "games": n_games,
        "moves": int(moves),
        "seconds": dt,
        "games_per_sec": n_games / dt,
        "moves_per_sec": moves / dt,
        "black_wins": bw.value,
        "white_wins": ww.value,
        "draws": dr.value,
    }
