"""Plain Othello rules on the 8x8 board, batched in plain PyTorch.

The benchmark's own engine: after a run it works out again the games'
roots from the actions played and every position the program's search
reached. It walks
each of the eight rays square by square through a table of ray squares,
one gather per step, where the program floods whole bitboards; the two
share no code.

Board words are int64, bit ``i`` the square ``(row i // 8, col i % 8)``,
``me`` the side to move. Actions are ``row * 8 + col`` and 64, the pass.

Rules ``"reference"`` are those of the upstream Cython engine: a ray's
next square is refused when it falls off the 64 squares or into the file
that the direction's mask removes *after* the shift (file A for the
westward rays, file H for the eastward ones). So a ray cannot end on the
far edge file, and a ray that starts on the near edge file wraps to the
next row. Rules ``"standard"`` refuse the file a ray would wrap into.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

SIDE = 8
SQUARES = SIDE * SIDE
PASS = SQUARES
OFF = SQUARES  # the index of the off-board cell every table points past the edge to
# (delta, column removed after the shift under "reference", under "standard");
# None: no column is removed
DIRECTIONS = ((-8, None, None), (8, None, None), (-1, 0, 7), (1, 7, 0),
              (-9, 0, 7), (-7, 7, 0), (7, 0, 7), (9, 7, 0))
STEPS = SIDE - 1  # the most squares a ray can cross
CHUNK = 65536  # positions a call works on at once, which bounds its memory


def ray_table(rules: str) -> torch.Tensor:
    """(8, 64, 7) int64: the k-th square along each ray from each square,
    :data:`OFF` once the ray has left the board."""
    if rules not in ("reference", "standard"):
        raise ValueError(f"rules must be 'reference' or 'standard', got {rules!r}")
    col = 1 if rules == "reference" else 2
    table = []
    for d in DIRECTIONS:
        rays = []
        for p in range(SQUARES):
            ray, q = [], p
            for _ in range(STEPS):
                q = q + d[0] if q != OFF else OFF
                if q != OFF and not (0 <= q < SQUARES and (d[col] is None or q % SIDE != d[col])):
                    q = OFF
                ray.append(q)
            rays.append(ray)
        table.append(rays)
    return torch.tensor(table, dtype=torch.int64)


class Positions(NamedTuple):
    me: torch.Tensor  # (N,) int64
    opp: torch.Tensor  # (N,) int64


class Observed(NamedTuple):
    legal: torch.Tensor  # (N, 65) bool, the pass legal exactly when no square is
    terminal: torch.Tensor  # (N,) bool: neither side can place
    winner: torch.Tensor  # (N,) int64: sign of (own stones - opponent's)
    features: torch.Tensor  # (N, 8, 8, 3) f32: own stones, opponent's, legal squares


def cells(word: torch.Tensor) -> torch.Tensor:
    """(N,) int64 words -> (N, 65) bool cells, the last one the off-board cell."""
    idx = torch.arange(SQUARES, device=word.device)
    on = ((word[:, None] >> idx) & 1).bool()
    return torch.cat([on, torch.zeros_like(on[:, :1])], dim=1)


def word(cell: torch.Tensor) -> torch.Tensor:
    """(N, 64 or 65) bool cells -> (N,) int64 words."""
    idx = torch.arange(SQUARES, device=cell.device)
    return (cell[:, :SQUARES].to(torch.int64) << idx).sum(dim=1)


class Engine:
    """The rules above on any device; every method takes a batch."""

    def __init__(self, rules: str = "reference", device="cpu"):
        self.rules = rules
        self.rays = ray_table(rules).to(device)  # (8, 64, 7)

    def legal_squares(self, me: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
        """(N, 65) cells each -> (N, 64) bool: the empty squares from which
        some ray crosses one or more opponent's stones and then meets an own
        stone."""
        run = torch.ones((me.shape[0], 8, SQUARES), dtype=torch.bool, device=me.device)
        closed = torch.zeros_like(run)
        for k in range(STEPS):
            squares = self.rays[:, :, k]  # (8, 64)
            if k:
                closed |= run & me[:, squares]
            run &= opp[:, squares]
        return ~(me | opp)[:, :SQUARES] & closed.any(dim=1)

    def flips(self, me: torch.Tensor, opp: torch.Tensor, square: torch.Tensor) -> torch.Tensor:
        """(N, 65) cells and (N,) squares in 0..63 -> (N, 65) bool: the
        stones a stone placed on each game's square would flip."""
        rays = self.rays[:, square].permute(1, 0, 2)  # (N, 8, 7)
        on_opp, on_me = torch.gather(opp[:, None].expand(-1, 8, -1), 2, rays), \
            torch.gather(me[:, None].expand(-1, 8, -1), 2, rays)
        run = torch.ones_like(on_opp[:, :, 0])
        crossed = torch.zeros_like(on_opp)  # the opponent's stones crossed so far
        closed = torch.zeros_like(run)
        for k in range(STEPS):
            if k:
                closed |= run & on_me[:, :, k]
            run = run & on_opp[:, :, k] & ~closed
            crossed[:, :, k] = run
        taken = crossed & closed[:, :, None]
        hits = torch.zeros(me.shape, dtype=torch.int32, device=me.device)
        n = me.shape[0]
        hits.scatter_add_(1, torch.where(taken, rays, OFF).reshape(n, -1),
                          taken.reshape(n, -1).to(torch.int32))
        hits[:, OFF] = 0
        return hits > 0

    def observe(self, pos: Positions) -> Observed:
        parts = [self._observe(Positions(me, opp))
                 for me, opp in zip(pos.me.split(CHUNK), pos.opp.split(CHUNK))]
        return Observed(*(torch.cat(field) for field in zip(*parts)))

    def step(self, pos: Positions, action: torch.Tensor) -> Tuple[Positions, torch.Tensor]:
        """Play ``action`` (N,) in 0..64. Returns the position with the
        other side to move, and whether the action was legal; an illegal
        action leaves the position as it was, the same side to move."""
        parts = [self._step(Positions(me, opp), a) for me, opp, a in
                 zip(pos.me.split(CHUNK), pos.opp.split(CHUNK), action.split(CHUNK))]
        return (Positions(torch.cat([p.me for p, _ in parts]),
                          torch.cat([p.opp for p, _ in parts])),
                torch.cat([ok for _, ok in parts]))

    def _observe(self, pos: Positions) -> Observed:
        me, opp = cells(pos.me), cells(pos.opp)
        mine = self.legal_squares(me, opp)
        theirs = self.legal_squares(opp, me)
        stuck = ~mine.any(dim=1)
        legal = torch.cat([mine, stuck[:, None]], dim=1)
        diff = me.sum(dim=1) - opp.sum(dim=1)
        feats = torch.stack([me[:, :SQUARES], opp[:, :SQUARES], mine], dim=2).to(torch.float32)
        return Observed(legal, stuck & ~theirs.any(dim=1), torch.sign(diff),
                        feats.reshape(-1, SIDE, SIDE, 3))

    def _step(self, pos: Positions, action: torch.Tensor) -> Tuple[Positions, torch.Tensor]:
        me, opp = cells(pos.me), cells(pos.opp)
        is_pass = action == PASS
        square = torch.where(is_pass, 0, action)
        flipped = self.flips(me, opp, square)
        n = me.shape[0]
        rows = torch.arange(n, device=me.device)
        empty = ~(me | opp)[rows, square]
        placing = ~is_pass & empty & flipped.any(dim=1)
        passing = is_pass & ~self.legal_squares(me, opp).any(dim=1)
        placed = torch.zeros_like(me)
        placed[rows, square] = placing
        new_me = torch.where(placing[:, None], opp & ~flipped, opp)
        new_opp = torch.where(placing[:, None], me | placed | flipped, me)
        ok = placing | passing
        return (Positions(torch.where(ok, word(new_me), pos.me),
                          torch.where(ok, word(new_opp), pos.opp)), ok)


def initial(n: int, device="cpu") -> Positions:
    """The opening position: own (black) stones on d5 and e4."""
    black = (1 << 28) | (1 << 35)
    white = (1 << 27) | (1 << 36)
    full = torch.full((n,), 0, dtype=torch.int64, device=device)
    return Positions(full + black, full + white)
