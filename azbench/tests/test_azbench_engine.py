"""The benchmark's plain engine against the program's."""

import pytest
import torch

from azbench.reference import engine as E
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import Board, OthelloEngine


@pytest.mark.parametrize("rules", ["reference", "standard"])
def test_engine_matches_program_engine(rules):
    ref, prog = E.Engine(rules), OthelloEngine(8, rules)
    gen = torch.Generator().manual_seed(7)
    n = 512
    pos = E.initial(n)
    for _ in range(64):
        ob = ref.observe(pos)
        board = Board(pos.me, pos.opp, torch.zeros(n, dtype=torch.int32),
                      torch.zeros(n, dtype=torch.bool))
        legal, term, win, feats = prog.observe(board, with_features=True)
        assert torch.equal(legal, ob.legal)
        assert torch.equal(term, ob.terminal)
        assert torch.equal(win.long(), ob.winner)
        assert torch.equal(feats, ob.features)
        pick = torch.argmax(torch.where(ob.legal, torch.rand(n, 65, generator=gen), -1.0), 1)
        wild = torch.where(torch.rand(n, generator=gen) < 0.2,
                           torch.randint(0, 65, (n,), generator=gen), pick)
        mine, ok = ref.step(pos, wild)
        theirs, their_ok = prog.step(board, wild)
        assert torch.equal(ok, their_ok)
        assert torch.equal(mine.me, theirs.me) and torch.equal(mine.opp, theirs.opp)
        pos, _ = ref.step(pos, pick)
