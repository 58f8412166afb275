"""Batched Othello bitboard engine on int64 tensors.

Port of ``OthelloEngine`` in ``othello_reinforcement_learning_test_tpu/
ops/bitboard.py``. Boards are two int64 words (side to move ``me`` and
``opp``, see :mod:`.bits`); every operation is a batched bit-parallel flood
fill with no per-square loop. The eight flood directions are a trailing
tensor axis of size 8, so one elementwise op advances all eight rays.

Board layout: bit ``i`` is square ``(row=i//8, col=i%8)``. ``step`` swaps
perspectives after every move, passes included.

Rule sets (see the reference module's docstring):

- ``rules="reference"`` reproduces the reference engine's edge quirks: a
  direction's wrap mask is applied after the shift, so a ray whose
  bracketing stone lies on the far edge file is not recognised and a ray
  starting on the near edge file can wrap to the next row;
- ``rules="standard"`` uses the correct anti-wrap masks.

Sizes 4 and 6 embed the SxS board in the 8-wide bit layout with a validity
mask. The action space is ``S*S + 1``; action ``S*S`` is the pass.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from . import bits

FULL = 0xFFFFFFFFFFFFFFFF
FILE_A = 0x0101010101010101
FILE_H = 0x8080808080808080
NOT_A = FULL ^ FILE_A
NOT_H = FULL ^ FILE_H

# (delta, reference post-shift mask, standard post-shift mask), in the
# reference's order: up, down, left, right, up-left, up-right, down-left,
# down-right.
_DIRECTIONS = (
    (-8, FULL, FULL),
    (8, FULL, FULL),
    (-1, NOT_A, NOT_H),
    (1, NOT_H, NOT_A),
    (-9, NOT_A, NOT_H),
    (-7, NOT_H, NOT_A),
    (7, NOT_A, NOT_H),
    (9, NOT_H, NOT_A),
)

# Longest opponent chain a ray can cross on the 8-wide layout, less one.
_FLOOD_ITERS = 6


class Board(NamedTuple):
    """Batch of positions; ``me`` is always the side to move."""

    me: torch.Tensor  # (...) int64
    opp: torch.Tensor  # (...) int64
    move_count: torch.Tensor  # (...) int32
    passed: torch.Tensor  # (...) bool


class _DirConsts(NamedTuple):
    mask: torch.Tensor  # (8,) int64 post-shift masks
    left: torch.Tensor  # (8,) shift amounts for delta > 0
    right: torch.Tensor  # (8,) shift amounts for delta < 0
    rmask: torch.Tensor  # (8,) masks that make the right shift logical


def _dir_consts(deltas, masks, device) -> _DirConsts:
    left = [max(d, 0) for d in deltas]
    right = [max(-d, 0) for d in deltas]
    rmask = [(1 << (64 - r)) - 1 if r else -1 for r in right]

    def t(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    return _DirConsts(t([bits.s64(m) for m in masks]), t(left), t(right), t(rmask))


def _shift(x: torch.Tensor, c: _DirConsts) -> torch.Tensor:
    """Shift each of the 8 direction lanes of ``x`` (..., 8) by its delta."""
    return ((x << c.left) >> c.right) & c.rmask


def _or8(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the trailing direction axis of size 8."""
    x = x[..., :4] | x[..., 4:]
    x = x[..., :2] | x[..., 2:]
    return x[..., 0] | x[..., 1]


class OthelloEngine:
    """Static-config engine; every method is a pure function of tensors.

    Board tensors may live on any device; the per-direction constants are
    built once per device.
    """

    def __init__(self, size: int = 8, rules: str = "reference"):
        if not (4 <= size <= 8 and size % 2 == 0):
            raise ValueError(f"size must be 4, 6 or 8 (got {size})")
        if rules not in ("reference", "standard"):
            raise ValueError(f"rules must be 'reference' or 'standard' (got {rules!r})")
        self.size = size
        self.rules = rules
        self.num_actions = size * size + 1
        self.pass_action = size * size

        valid = 0
        for r in range(size):
            for c in range(size):
                valid |= 1 << (r * 8 + c)
        self._valid = bits.s64(valid)
        mask_idx = 1 if rules == "reference" else 2
        deltas = [d[0] for d in _DIRECTIONS]
        masks = [d[mask_idx] for d in _DIRECTIONS]
        # floods walk each direction forwards (flips) or backwards (legal)
        self._fwd_spec = (deltas, masks)
        self._bwd_spec = ([-d for d in deltas], masks)
        self._consts: Dict[torch.device, Tuple[_DirConsts, _DirConsts]] = {}

        r0 = size // 2 - 1
        self._init_black = (1 << (r0 * 8 + r0 + 1)) | (1 << ((r0 + 1) * 8 + r0))
        self._init_white = (1 << (r0 * 8 + r0)) | (1 << ((r0 + 1) * 8 + r0 + 1))

    def __repr__(self):
        return f"OthelloEngine(size={self.size}, rules={self.rules!r})"

    def _dirs(self, device: torch.device) -> Tuple[_DirConsts, _DirConsts]:
        if device not in self._consts:
            self._consts[device] = (
                _dir_consts(*self._fwd_spec, device),
                _dir_consts(*self._bwd_spec, device),
            )
        return self._consts[device]

    # -- state construction ----------------------------------------------
    def initial_state(self, batch_shape: Tuple[int, ...] = (),
                      device="cpu") -> Board:
        full = functools.partial(torch.full, batch_shape, device=device)
        return Board(
            me=full(self._init_black, dtype=torch.int64),
            opp=full(self._init_white, dtype=torch.int64),
            move_count=full(0, dtype=torch.int32),
            passed=full(False, dtype=torch.bool),
        )

    # -- core bit floods ---------------------------------------------------
    def legal_squares(self, me: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
        """Bitmask of legal placement squares.

        Reverse flood: from own stones walk backwards through opponent
        chains; landing on an empty square marks a legal move. Chain squares
        and the bracketing stone carry the direction's post-shift mask, the
        landing square does not, which reproduces the reference's per-square
        forward ray scan, quirks included.
        """
        _, bwd = self._dirs(me.device)
        empty = (~(me | opp)) & self._valid
        prop = opp[..., None] & bwd.mask
        y = _shift(me[..., None] & bwd.mask, bwd) & prop
        for _ in range(_FLOOD_ITERS):
            y = y | (_shift(y, bwd) & prop)
        return _or8(_shift(y, bwd) & empty[..., None])

    def flips(self, me: torch.Tensor, opp: torch.Tensor,
              move: torch.Tensor) -> torch.Tensor:
        """All stones flipped by placing on one-hot word ``move`` (0 allowed)."""
        fwd, _ = self._dirs(me.device)
        prop = opp[..., None] & fwd.mask
        f = _shift(move[..., None], fwd) & prop
        for _ in range(_FLOOD_ITERS):
            f = f | (_shift(f, fwd) & prop)
        terminator = _shift(f, fwd) & fwd.mask & ~f
        ok = (terminator & me[..., None]) != 0
        return _or8(torch.where(ok, f, torch.zeros_like(f)))

    # -- action mapping ------------------------------------------------------
    def action_to_bitpos(self, action: torch.Tensor) -> torch.Tensor:
        """Action index (row*S+col) -> bit index (row*8+col); pass -> -1."""
        s = self.size
        pos = (action // s) * 8 + (action % s)
        return torch.where(action >= self.pass_action, -1, pos).to(torch.int64)

    def squares_to_actions(self, mask: torch.Tensor) -> torch.Tensor:
        """Square bitmask (...) -> per-action bool planes (..., S*S)."""
        planes = bits.to_planes(mask, torch.bool)
        grid = planes.reshape(*planes.shape[:-1], 8, 8)
        s = self.size
        return grid[..., :s, :s].reshape(*planes.shape[:-1], s * s)

    def legal_actions(self, state: Board) -> torch.Tensor:
        """(..., A) bool mask; the pass is legal iff no square is."""
        sq = self.squares_to_actions(self.legal_squares(state.me, state.opp))
        return torch.cat([sq, ~sq.any(dim=-1, keepdim=True)], dim=-1)

    # -- stepping -------------------------------------------------------------
    def step(self, state: Board, action: torch.Tensor,
             pass_legal: torch.Tensor = None) -> Tuple[Board, torch.Tensor]:
        """Apply ``action`` (...) in [0, S*S]; returns ``(new, valid)``.

        Invalid actions leave the board unchanged with ``valid=False``. A
        pass is valid only when no placement is. ``pass_legal`` lets a caller
        that already ran :meth:`observe` skip the legal-move flood.
        """
        action = action.to(torch.int64)
        is_pass = action == self.pass_action
        move = bits.bit(self.action_to_bitpos(action))
        if pass_legal is None:
            pass_legal = self.legal_squares(state.me, state.opp) == 0
        f = self.flips(state.me, state.opp, move)
        occupied = ((state.me | state.opp) & move) != 0
        valid = (~is_pass & (f != 0) & ~occupied) | (is_pass & pass_legal)

        zero = torch.zeros_like(move)
        placed = torch.where(valid, move, zero)
        flip = torch.where(valid, f, zero)
        return (
            Board(
                me=torch.where(valid, state.opp & ~flip, state.me),
                opp=torch.where(valid, state.me | placed | flip, state.opp),
                move_count=state.move_count + valid.to(torch.int32),
                passed=torch.where(valid, is_pass, state.passed),
            ),
            valid,
        )

    # -- termination ----------------------------------------------------------
    def is_terminal(self, state: Board) -> torch.Tensor:
        """True when neither side can place."""
        return ((self.legal_squares(state.me, state.opp) == 0)
                & (self.legal_squares(state.opp, state.me) == 0))

    def winner(self, state: Board) -> torch.Tensor:
        """+1 side to move wins, -1 loses, 0 draw (int32)."""
        diff = bits.popcount(state.me) - bits.popcount(state.opp)
        return torch.sign(diff).to(torch.int32)

    def stone_counts(self, state: Board) -> Tuple[torch.Tensor, torch.Tensor]:
        return bits.popcount(state.me), bits.popcount(state.opp)

    # -- fused observation ------------------------------------------------------
    def observe(self, state: Board, with_features: bool = False):
        """Both sides' legal floods once, and everything derived from them.

        Returns ``(legal_actions (..., A) bool, terminal (...), winner (...))``
        or, with ``with_features``, also ``features (..., S, S, 3)``.
        """
        both = self.legal_squares(torch.stack([state.me, state.opp]),
                                  torch.stack([state.opp, state.me]))
        legal_me, legal_opp = both[0], both[1]
        sq_mask = self.squares_to_actions(legal_me)
        me_stuck = legal_me == 0
        terminal = me_stuck & (legal_opp == 0)
        legal = torch.cat([sq_mask, me_stuck[..., None]], dim=-1)
        winner = self.winner(state)
        if not with_features:
            return legal, terminal, winner
        return legal, terminal, winner, self._planes(state.me, state.opp, legal_me)

    def _planes(self, me, opp, legal_sq) -> torch.Tensor:
        words = torch.stack([me, opp, legal_sq], dim=-1)  # (..., 3)
        planes = bits.to_planes(words, torch.float32)  # (..., 3, 64)
        g = planes.reshape(*words.shape[:-1], 3, 8, 8)[..., : self.size, : self.size]
        return g.movedim(-3, -1).contiguous()

    def features(self, state: Board) -> torch.Tensor:
        """(..., S, S, 3) float32: own stones / opponent stones / legal mask
        (NHWC, as in the JAX package)."""
        return self._planes(state.me, state.opp,
                            self.legal_squares(state.me, state.opp))

    # -- symmetries ---------------------------------------------------------------
    def symmetries(self, features: torch.Tensor,
                   pi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """All 8 D4 images of ``(features (..., S, S, C), pi (..., S*S+1))``,
        stacked on a new axis before the spatial axes: for k in 0..3,
        rot90(k), then rot90(k) with a horizontal flip. The pass action stays
        in place."""
        s = self.size
        pi_grid = pi[..., : s * s].reshape(*pi.shape[:-1], s, s)
        pi_pass = pi[..., s * s:]
        feats, pis = [], []
        for k in range(4):
            fb = torch.rot90(features, k, dims=(-3, -2))
            pb = torch.rot90(pi_grid, k, dims=(-2, -1))
            for flip in (False, True):
                fb2 = torch.flip(fb, dims=(-2,)) if flip else fb
                pb2 = torch.flip(pb, dims=(-1,)) if flip else pb
                feats.append(fb2)
                pis.append(torch.cat([pb2.reshape(*pi.shape[:-1], s * s), pi_pass], dim=-1))
        return (torch.stack(feats, dim=features.dim() - 3),
                torch.stack(pis, dim=pi.dim() - 1))

    # -- host-side pretty printing ---------------------------------------------
    def to_string(self, state: Board) -> str:
        """ASCII board for a single (unbatched) state; ● = side to move.
        Square (r, c) is bit ``r * 8 + c`` at every size, as in the JAX
        engine."""
        if state.me.dim() != 0:
            raise ValueError("to_string takes a single unbatched board")
        me = bits.to_planes(state.me.cpu(), torch.int32).tolist()
        opp = bits.to_planes(state.opp.cpu(), torch.int32).tolist()
        lines = ["  " + " ".join("ABCDEFGH"[: self.size])]
        for r in range(self.size):
            row = [f"{r + 1} "]
            for c in range(self.size):
                i = r * 8 + c
                row.append("● " if me[i] else ("○ " if opp[i] else ". "))
            lines.append("".join(row).rstrip())
        return "\n".join(lines)


@functools.lru_cache(maxsize=None)
def get_engine(size: int = 8, rules: str = "reference") -> OthelloEngine:
    return OthelloEngine(size=size, rules=rules)
