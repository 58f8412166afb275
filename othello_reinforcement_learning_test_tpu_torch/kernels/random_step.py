"""One uniform-random ply per game: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel ``_make_step_kernel``
(``othello_reinforcement_learning_test_tpu/ops/pallas_step.py:162``),
reached through ``random_step`` (``:205``). The kernel is
``csrc/random_step.cu``; its note states the bound and the design.

Layout, as the JAX function's: ``boards`` is ``(4, *shape)`` uint32 planes
``[me_lo, me_hi, opp_lo, opp_hi]`` (the JAX package uses ``shape = (R,
128)``), ``words`` is ``(2, *shape)`` uint32 ``[lo, hi]``: two uniform
words per game, drawn outside the kernel as in Pallas (:func:`draw_words`),
so two implementations fed the same words must give the same boards.

:func:`random_step` launches the kernel for a CUDA tensor and uses
:func:`random_step_plain` only for a tensor on the CPU. The plain version
joins each u32 pair into one of the engine's int64 board words and reuses
the port's engine floods (``ops/bitboard.py``), which compute the Pallas
kernel's ``_legal`` and ``_flips``; it runs on either device.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..ops import bits
from ..ops.bitboard import _DIRECTIONS, get_engine
from . import build

_MASK32 = 0xFFFFFFFF


def draw_words(shape, generator: torch.Generator) -> torch.Tensor:
    """``(2, *shape)`` uniform uint32 words on the generator's device."""
    words = torch.randint(-2 ** 31, 2 ** 31, (2, *shape), dtype=torch.int32,
                          generator=generator, device=generator.device)
    return words.view(torch.uint32)


def to_words64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """u32 planes -> int64 words with the same 64 bits."""
    lo = lo.view(torch.int32).to(torch.int64) & _MASK32
    return lo | (hi.view(torch.int32).to(torch.int64) << 32)


def to_planes32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 words -> (lo, hi) u32 planes."""
    lo = (x & _MASK32).to(torch.int32).view(torch.uint32)
    return lo, ((x >> 32) & _MASK32).to(torch.int32).view(torch.uint32)


def mod64(lo: torch.Tensor, hi: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Exact ``(hi * 2^32 + lo) mod n`` for int64 ``lo``, ``hi`` in [0, 2^32)
    and 1 <= n <= 64, in int64 without overflow (the Pallas ``_mod64``)."""
    r2 = torch.remainder(torch.full_like(n, 2 ** 32), n)
    return ((hi % n) * r2 + lo % n) % n


def kth_set_bit(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """One-hot int64 word of the k-th (0-based) set bit of ``x``, for
    ``k < popcount(x)``; 0 where ``x`` is 0. A ladder over halves, quarters,
    ... of the word, as the kernel's."""
    w = x & _MASK32
    c = bits.popcount(w).to(torch.int64)
    up = k >= c
    k = torch.where(up, k - c, k)
    w = torch.where(up, (x >> 32) & _MASK32, w)
    pos = torch.where(up, 32, 0)
    for width in (16, 8, 4, 2, 1):
        c = bits.popcount(w & ((1 << width) - 1)).to(torch.int64)
        up = k >= c
        k = torch.where(up, k - c, k)
        w = torch.where(up, w >> width, w)
        pos = pos + torch.where(up, width, 0)
    return torch.where(x != 0, bits.bit(pos), 0)


def _check(boards: torch.Tensor, words: torch.Tensor) -> None:
    if boards.dtype != torch.uint32 or boards.shape[0] != 4:
        raise ValueError(f"boards must be uint32 (4, ...), got {boards.dtype} {tuple(boards.shape)}")
    if words.dtype != torch.uint32 or words.shape != (2, *boards.shape[1:]):
        raise ValueError(f"words must be uint32 (2, {', '.join(map(str, boards.shape[1:]))}), "
                         f"got {words.dtype} {tuple(words.shape)}")
    if words.device != boards.device:
        raise ValueError(f"words must be on {boards.device}, got {words.device}")


def random_step_plain(boards: torch.Tensor, words: torch.Tensor, size: int = 8,
                      rules: str = "reference") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on either device. Returns
    ``(new boards (4, *shape) uint32, live (*shape) int32)``."""
    _check(boards, words)
    eng = get_engine(size, rules)
    me, op = to_words64(boards[0], boards[1]), to_words64(boards[2], boards[3])
    both = eng.legal_squares(torch.stack([me, op]), torch.stack([op, me]))
    lg = both[0]
    has_move = lg != 0
    live = has_move | (both[1] != 0)
    n = bits.popcount(lg).to(torch.int64).clamp_min(1)
    k = mod64(words[0].view(torch.int32).to(torch.int64) & _MASK32,
              words[1].view(torch.int32).to(torch.int64) & _MASK32, n)
    mv = kth_set_bit(lg, k)
    f = eng.flips(me, op, mv)
    new_me = torch.where(has_move, op & ~f, op)
    new_op = torch.where(has_move, me | mv | f, me)
    new_me = torch.where(live, new_me, me)
    new_op = torch.where(live, new_op, op)
    return torch.stack([*to_planes32(new_me), *to_planes32(new_op)]), live.to(torch.int32)


def engine_tables(size: int, rules: str) -> Tuple[Tuple[int, ...], int]:
    """(eight post-shift direction masks, board-validity mask) as unsigned
    64-bit ints: the kernel's arguments for one (size, rules) pair."""
    get_engine(size, rules)  # validates size and rules
    idx = 1 if rules == "reference" else 2
    valid = sum(1 << (r * 8 + c) for r in range(size) for c in range(size))
    return tuple(d[idx] for d in _DIRECTIONS), valid


def _library() -> ctypes.CDLL:
    lib = build.load("random_step")
    if lib.random_step_launch.argtypes is None:
        p = ctypes.c_void_p
        lib.random_step_launch.argtypes = [p, p, p, p, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_uint64),
                                           ctypes.c_uint64, p]
        lib.random_step_launch.restype = ctypes.c_int
    return lib


def random_step(boards: torch.Tensor, words: torch.Tensor, size: int = 8,
                rules: str = "reference") -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance every game one random ply. Returns ``(new boards (4, *shape)
    uint32, live (*shape) int32)``; ``live`` marks games that were not
    terminal before the step, and terminal boards pass through unchanged.

    On a CUDA tensor this launches the hand-written kernel (each launch
    counted in ``random_step.launches``) or raises; the plain version runs
    only for a tensor on the CPU.
    """
    _check(boards, words)
    if boards.device.type == "cpu":
        return random_step_plain(boards, words, size, rules)
    if boards.device.type != "cuda":
        raise ValueError(f"unsupported device {boards.device}")
    boards, words = boards.contiguous(), words.contiguous()
    n = boards[0].numel()
    masks, valid = engine_tables(size, rules)
    out = torch.empty_like(boards)
    live = torch.empty(boards.shape[1:], dtype=torch.int32, device=boards.device)
    if n == 0:
        return out, live
    lib = _library()
    with torch.cuda.device(boards.device):
        stream = torch.cuda.current_stream(boards.device).cuda_stream
        rc = lib.random_step_launch(boards.data_ptr(), words.data_ptr(), out.data_ptr(),
                                    live.data_ptr(), n, (ctypes.c_uint64 * 8)(*masks),
                                    valid, stream)
        if rc != 0:
            raise RuntimeError(f"random_step launch failed: CUDA error {rc}")
        random_step.launches += 1
    return out, live


random_step.launches = 0
