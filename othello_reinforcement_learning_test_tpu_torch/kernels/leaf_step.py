"""The search's leaf step in one launch: CUDA kernel wrapper and plain version.

Replaces no TPU kernel: the JAX package's search runs its leaf step as XLA
operations fused under ``jit``, where the port's eager search ran it as
about 227 small operations a simulation. The kernel is
``csrc/leaf_step.cu``; its note states the bound and the design.

The step (``search/mcts.py::_step_leaf``): for every game, gather the
selected parent's board and cached pass legality from the tree, play the
selected action with ``OthelloEngine.step``'s rules (an invalid action
leaves the board as it was), and observe the child with
``OthelloEngine.observe(with_features=True)``. :func:`leaf_step` launches
the kernel for CUDA tensors and uses :func:`leaf_step_plain`, that
composition of the engine's own calls, only for tensors on the CPU.
:func:`sample_case` makes the trees the kernel is checked on.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..ops.bitboard import Board, get_engine
from . import build
from .random_step import engine_tables

LeafStep = Tuple[Board, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def leaf_step_plain(engine, board_me: torch.Tensor, board_opp: torch.Tensor,
                    legal: torch.Tensor, parent: torch.Tensor, action: torch.Tensor,
                    zeros: torch.Tensor) -> LeafStep:
    """Plain PyTorch version of the kernel, on either device: the parent's
    rows of the tree, ``engine.step`` with the cached pass legality, then
    ``engine.observe(child, with_features=True)``."""
    rows = torch.arange(parent.shape[0], device=parent.device)
    state = Board(me=board_me[rows, parent], opp=board_opp[rows, parent],
                  move_count=zeros, passed=zeros.to(torch.bool))
    # the parent's pass legality is cached in the tree, so step skips its
    # legal-move flood
    pass_legal = legal[rows, parent][:, engine.pass_action]
    child, _ = engine.step(state, action, pass_legal=pass_legal)
    return (child, *engine.observe(child, with_features=True))


def _check(engine, board_me, board_opp, legal, parent, action, zeros) -> None:
    if board_me.dim() != 2:
        raise ValueError(f"board_me must be (B, N), got {tuple(board_me.shape)}")
    B, N = board_me.shape
    dev = board_me.device
    for name, t, dtype, shape in (
            ("board_me", board_me, torch.int64, (B, N)),
            ("board_opp", board_opp, torch.int64, (B, N)),
            ("legal", legal, torch.bool, (B, N, engine.num_actions)),
            ("parent", parent, torch.int64, (B,)),
            ("action", action, torch.int64, (B,)),
            ("zeros", zeros, torch.int32, (B,))):
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {t.device}")


@functools.lru_cache(maxsize=None)
def _tables(size: int, rules: str):
    """The kernel's direction masks (a ctypes array) and validity mask for
    one (size, rules) pair, built once."""
    masks, valid = engine_tables(size, rules)
    return (ctypes.c_uint64 * 8)(*masks), valid


def _library() -> ctypes.CDLL:
    lib = build.load("leaf_step")
    if lib.leaf_step_launch.argtypes is None:
        p = ctypes.c_void_p
        lib.leaf_step_launch.argtypes = [p] * 14 + [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, p]
        lib.leaf_step_launch.restype = ctypes.c_int
    return lib


def leaf_step(engine, board_me: torch.Tensor, board_opp: torch.Tensor, legal: torch.Tensor,
              parent: torch.Tensor, action: torch.Tensor, zeros: torch.Tensor) -> LeafStep:
    """Play ``action[b]`` from node ``parent[b]`` of every game's tree:
    ``(child board, legal, terminal, winner, features)``, as
    :func:`leaf_step_plain` returns them. ``board_me``, ``board_opp``
    (B, N) int64 and ``legal`` (B, N, A) bool are the tree's node pools;
    ``zeros``: (B,) int32 move counts of 0.

    On CUDA tensors this launches the hand-written kernel (each launch
    counted in ``leaf_step.launches``) or raises; the plain version runs
    only for tensors on the CPU.
    """
    _check(engine, board_me, board_opp, legal, parent, action, zeros)
    dev = board_me.device
    if dev.type == "cpu":
        return leaf_step_plain(engine, board_me, board_opp, legal, parent, action, zeros)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, N = board_me.shape
    S = engine.size

    def empty(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    child = Board(me=empty(B, dtype=torch.int64), opp=empty(B, dtype=torch.int64),
                  move_count=empty(B, dtype=torch.int32), passed=empty(B, dtype=torch.bool))
    c_legal, terminal = empty(B, S * S + 1, dtype=torch.bool), empty(B, dtype=torch.bool)
    winner, features = empty(B, dtype=torch.int32), empty(B, S, S, 3, dtype=torch.float32)
    masks, valid = _tables(S, engine.rules)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.leaf_step_launch(
            board_me.data_ptr(), board_opp.data_ptr(), legal.data_ptr(), parent.data_ptr(),
            action.data_ptr(), zeros.data_ptr(), child.me.data_ptr(), child.opp.data_ptr(),
            child.move_count.data_ptr(), child.passed.data_ptr(), c_legal.data_ptr(),
            terminal.data_ptr(), winner.data_ptr(), features.data_ptr(), B, N, S, masks, valid,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"leaf_step launch failed: CUDA error {rc}")
        leaf_step.launches += 1
    return child, c_legal, terminal, winner, features


leaf_step.launches = 0


@functools.lru_cache(maxsize=None)
def _positions(size: int, rules: str, games: int = 256, seed: int = 0):
    """(me, opp, kind) of every position ``games`` random games reach, on
    the CPU; kind 0 a position with a move, 1 one where only the pass is
    legal, 2 the end of the game."""
    eng = get_engine(size, rules)
    gen = torch.Generator().manual_seed(seed)
    boards = eng.initial_state((games,))
    seen_me, seen_opp = [], []
    for _ in range(size * size):
        seen_me.append(boards.me)
        seen_opp.append(boards.opp)
        legal = eng.legal_actions(boards).to(torch.float32)
        boards, _ = eng.step(boards, torch.multinomial(legal, 1, generator=gen)[:, 0])
    me, opp = torch.cat(seen_me), torch.cat(seen_opp)
    mine = eng.legal_squares(me, opp) != 0
    theirs = eng.legal_squares(opp, me) != 0
    kind = torch.where(mine, 0, torch.where(theirs, 1, 2))
    return me, opp, kind


def sample_case(size: int, rules: str, batch: int, slots: int, seed: int, device="cpu"):
    """What ``search/mcts.py::_step_leaf`` reads, for checking the kernel:
    ``(board_me, board_opp, legal, parent, action, zeros)`` for ``batch``
    games of ``slots`` tree slots. The slots hold positions of random
    games: openings, middle games, pass-only positions and ends. A quarter
    of the parents end the game, with the action 0 the walk gives them; an
    eighth can only pass. The other actions mix the parent's legal moves,
    the pass and arbitrary actions (mostly invalid)."""
    eng = get_engine(size, rules)
    me, opp, kind = _positions(size, rules)
    gen = torch.Generator().manual_seed(seed)
    pick = torch.randint(0, len(me), (batch, slots), generator=gen)
    parent = torch.randint(0, slots, (batch,), generator=gen)
    # plant terminal and pass-only positions at the parents of some games
    rows = torch.arange(batch)
    for k, share in ((2, 4), (1, 8)):
        pool = torch.nonzero(kind == k)[:, 0]
        chosen = torch.randint(0, share, (batch,), generator=gen) == 0
        planted = pool[torch.randint(0, len(pool), (batch,), generator=gen)]
        pick[rows, parent] = torch.where(chosen, planted, pick[rows, parent])
    board_me, board_opp = me[pick], opp[pick]
    legal = eng.legal_actions(Board(board_me, board_opp, None, None))

    # actions: a legal move of the parent, the pass, or any action at all
    p_legal = legal[rows, parent].to(torch.float32)
    legal_pick = torch.multinomial(p_legal, 1, generator=gen)[:, 0]
    anything = torch.randint(0, eng.num_actions, (batch,), generator=gen)
    how = torch.randint(0, 4, (batch,), generator=gen)
    action = torch.where(how == 0, anything,
                         torch.where(how == 1, eng.pass_action, legal_pick))
    action = torch.where(kind[pick[rows, parent]] == 2, 0, action)
    zeros = torch.zeros(batch, dtype=torch.int32)
    return tuple(t.to(device) for t in (board_me, board_opp, legal, parent, action, zeros))
