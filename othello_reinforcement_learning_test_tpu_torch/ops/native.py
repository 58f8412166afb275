"""ctypes binding of the repository's C++ host engine, ``csrc/othello_native.cpp``.

The port's own copy of what it needs from the JAX package's ``ops/native.py``
(that module cannot be imported without JAX): :func:`best_move`, the
alpha-beta search behind ``NativeMinimaxPlayer``, and :func:`legal` and
:func:`flips` for checks against the tensor engine. 8x8 only: the engine
works on one 64-bit word per side.

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
from pathlib import Path
from typing import Tuple

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
    u64, i32 = ctypes.c_uint64, ctypes.c_int
    lib.oth_legal.restype = u64
    lib.oth_legal.argtypes = [u64, u64, i32]
    lib.oth_flips.restype = u64
    lib.oth_flips.argtypes = [u64, u64, i32, i32]
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
