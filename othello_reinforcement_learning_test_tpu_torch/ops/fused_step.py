"""Random self-play to the end of every game through the random-step kernel.

Host half of ``othello_reinforcement_learning_test_tpu/ops/pallas_step.py``:
``pack_boards``, ``unpack_boards`` and ``play_random_games``. The ply itself
is ``kernels/random_step.py`` (the CUDA kernel on the card, its plain
version on the CPU).

Layouts: the packed boards are the JAX function's ``(4, B // 128, 128)``
uint32 planes ``[me_lo, me_hi, opp_lo, opp_hi]``, so a test compares like
with like; the unpacked boards are the port engine's int64 words ``(B,)``
where the JAX package has ``(B, 2)`` uint32 pairs.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..kernels.random_step import draw_words, random_step, to_planes32, to_words64


def pack_boards(me: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """(B,) int64 words -> (4, B // 128, 128) uint32 planes; B must be a
    multiple of 128."""
    B = me.shape[0]
    if B % 128:
        raise ValueError(f"batch must be a multiple of 128, got {B}")
    planes = (*to_planes32(me), *to_planes32(opp))
    return torch.stack([p.reshape(B // 128, 128) for p in planes])


def unpack_boards(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(4, R, 128) uint32 planes -> (me, opp) (R * 128,) int64 words."""
    flat = packed.reshape(4, -1)
    return to_words64(flat[0], flat[1]), to_words64(flat[2], flat[3])


def play_random_games(boards: torch.Tensor, generator: Optional[torch.Generator],
                      max_plies: int = 132, size: int = 8, rules: str = "reference",
                      words: Optional[Callable[[int], torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, int, int]:
    """Play every game of ``boards`` (packed, see :func:`pack_boards`) to
    its end with one :func:`random_step` per ply. Returns ``(final boards,
    env steps, plies)``, with the JAX function's loop semantics: the loop
    stops after the first ply in which no game was live, or at
    ``max_plies``; ``plies`` counts that last ply and ``steps`` sums
    ``live``.

    Each ply's random words come from ``words(ply)`` when it is given,
    else from :func:`draw_words` on ``generator``.
    """
    draw = words or (lambda _: draw_words(boards.shape[1:], generator))
    steps = torch.zeros((), dtype=torch.int64, device=boards.device)
    plies, any_live = 0, True
    while any_live and plies < max_plies:
        boards, live = random_step(boards, draw(plies), size=size, rules=rules)
        n_live = live.sum()
        steps += n_live
        plies += 1
        any_live = bool(n_live > 0)
    return boards, int(steps), plies
