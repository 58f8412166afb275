"""PyTorch port of the bitboard engine against the JAX engine and the
reference's golden games.

Tolerance: none. Boards, legal masks, features, terminal flags, winners
and stone counts are integers or 0/1 planes, so the port must match
bit for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.ops import bitboard as jbb
from othello_reinforcement_learning_test_tpu_torch.ops import bits
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import Board, OthelloEngine, get_engine
from othello_reinforcement_learning_test_tpu_torch.utils.device import resolve_device

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_games.json")


def to_i64(pair) -> np.ndarray:
    """JAX (..., 2) uint32 word -> int64 with the same 64 bits."""
    a = np.asarray(pair)
    return (a[..., 0].astype(np.uint64) | (a[..., 1].astype(np.uint64) << np.uint64(32))).view(np.int64)


def to_pair(words) -> np.ndarray:
    v = np.asarray(words, dtype=np.int64).view(np.uint64)
    return np.stack([(v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (v >> np.uint64(32)).astype(np.uint32)], axis=-1)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_trajectories(golden):
    """Replay the reference engine's random games: every board, legal mask,
    move count, pass flag, winner and final count matches."""
    eng = get_engine(8, "reference")
    for g in golden["games"]:
        s = eng.initial_state((1,))
        for st in g["steps"]:
            s, valid = eng.step(s, torch.tensor([st["action"]]))
            assert bool(valid[0])
            assert int(s.me[0]) == bits.s64(st["me"])
            assert int(s.opp[0]) == bits.s64(st["opp"])
            assert int(s.move_count[0]) == st["move_count"]
            assert bool(s.passed[0]) == st["passed"]
            assert int(eng.legal_squares(s.me, s.opp)[0]) == bits.s64(st["legal_bits"])
        assert bool(eng.is_terminal(s)[0])
        assert int(eng.winner(s)[0]) == g["winner"]
        assert [int(c[0]) for c in eng.stone_counts(s)] == g["counts"]


def test_golden_probes(golden):
    """The reference's edge quirks (post-shift masks, H1 east wrap)."""
    eng = get_engine(8, "reference")
    for p in golden["probes"]:
        me, opp = torch.tensor(bits.s64(p["me"])), torch.tensor(bits.s64(p["opp"]))
        assert int(eng.legal_squares(me, opp)) == bits.s64(p["legal_bits"]), p["desc"]
        s = Board(me, opp, torch.tensor(0, dtype=torch.int32), torch.tensor(False))
        assert bool(eng.is_terminal(s)) == p["is_terminal"], p["desc"]


def test_initial_position():
    eng = get_engine(8, "reference")
    s = eng.initial_state(())
    assert int(s.me) == (1 << 28) | (1 << 35)
    assert int(s.opp) == (1 << 27) | (1 << 36)
    legal = int(eng.legal_squares(s.me, s.opp))
    assert legal == (1 << 19) | (1 << 26) | (1 << 37) | (1 << 44)
    c_me, c_opp = eng.stone_counts(s)
    assert int(c_me) == 2 and int(c_opp) == 2 and not bool(eng.is_terminal(s))


def test_invalid_moves_rejected():
    eng = get_engine(8, "reference")
    s = eng.initial_state(())
    for action in (27, 0, 64):  # occupied, no flips, pass while moves exist
        s2, ok = eng.step(s, torch.tensor(action))
        assert not bool(ok)
        assert all(torch.equal(a, b) for a, b in zip(s2, s))


@pytest.mark.parametrize("size,rules", [(4, "reference"), (6, "reference"), (8, "reference"),
                                        (4, "standard"), (6, "standard"), (8, "standard")])
def test_random_games_match_jax(size, rules):
    """Random games stepped in lockstep on both engines; every ply compares
    boards, validity, observe (legal, terminal, winner, features), feature
    planes, stone counts and the pass_legal fast path."""
    B = 24
    jeng = jbb.get_engine(size, rules)
    teng = OthelloEngine(size, rules)
    j_step = jax.jit(jeng.step)
    j_observe = jax.jit(lambda s: jeng.observe(s, with_features=True))
    j_counts = jax.jit(jeng.stone_counts)
    rng = np.random.default_rng(size * 10 + (rules == "standard"))
    js = jeng.initial_state((B,))
    ts = teng.initial_state((B,))
    for _ in range(2 * size * size + 4):
        jl, jt, jw, jf = map(np.asarray, j_observe(js))
        tl, tt, tw, tf = teng.observe(ts, with_features=True)
        np.testing.assert_array_equal(tl.numpy(), jl)
        np.testing.assert_array_equal(tt.numpy(), jt)
        np.testing.assert_array_equal(tw.numpy(), jw)
        np.testing.assert_array_equal(tf.numpy(), jf)
        np.testing.assert_array_equal(teng.features(ts).numpy(), jf)
        np.testing.assert_array_equal(teng.legal_actions(ts).numpy(), jl)
        np.testing.assert_array_equal(teng.is_terminal(ts).numpy(), jt)
        jc = [np.asarray(c) for c in j_counts(js)]
        for a, b in zip(teng.stone_counts(ts), jc):
            np.testing.assert_array_equal(a.numpy(), b)
        # mostly legal moves, some random (often illegal) ones
        action = np.array([rng.choice(np.flatnonzero(row)) if rng.random() < 0.9
                           else rng.integers(0, size * size + 1) for row in jl])
        js, jvalid = j_step(js, action.astype(np.int32))
        ts_fast, _ = teng.step(ts, torch.from_numpy(action), pass_legal=tl[:, -1])
        ts, tvalid = teng.step(ts, torch.from_numpy(action))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(ts.me.numpy(), to_i64(js.me))
        np.testing.assert_array_equal(ts.opp.numpy(), to_i64(js.opp))
        np.testing.assert_array_equal(ts.move_count.numpy(), np.asarray(js.move_count))
        np.testing.assert_array_equal(ts.passed.numpy(), np.asarray(js.passed))
        for a, b in zip(ts_fast, ts):
            assert torch.equal(a, b)
    assert bool(teng.is_terminal(ts).all())
    np.testing.assert_array_equal(teng.winner(ts).numpy(), np.asarray(jeng.winner(js)))


@pytest.mark.parametrize("size,rules", [(8, "reference"), (8, "standard"), (6, "reference")])
def test_flips_match_jax(size, rules):
    """flips() for every square of random positions, legal or not."""
    jeng = jbb.get_engine(size, rules)
    teng = OthelloEngine(size, rules)
    rng = np.random.default_rng(3)
    occ = rng.random((16, 64)) < 0.7
    mine = rng.random((16, 64)) < 0.5
    me = bits.from_planes(torch.from_numpy(occ & mine))
    opp = bits.from_planes(torch.from_numpy(occ & ~mine))
    j_flips = jax.jit(jeng.flips)
    for sq in range(64):
        move = torch.full((16,), sq, dtype=torch.int64)
        t = teng.flips(me, opp, bits.bit(move))
        j = j_flips(to_pair(me.numpy()), to_pair(opp.numpy()),
                    to_pair((torch.ones_like(move) << sq).numpy()))
        np.testing.assert_array_equal(t.numpy(), to_i64(j))


@pytest.mark.parametrize("word", [0, 1, -(1 << 63), -1, 0x0123456789ABCDEF, -0x0123456789ABCDEF])
def test_bits_helpers(word):
    x = torch.tensor([word], dtype=torch.int64)
    u = int(np.int64(word).view(np.uint64))
    assert int(bits.popcount(x)[0]) == bin(u).count("1")
    planes = bits.to_planes(x, torch.int64)
    assert [int(p) for p in planes[0]] == [(u >> i) & 1 for i in range(64)]
    assert int(bits.from_planes(planes)[0]) == word


def test_bit_out_of_range_is_zero():
    pos = torch.tensor([-1, 0, 63, 64])
    np.testing.assert_array_equal(bits.bit(pos).numpy(), [0, 1, bits.s64(1 << 63), 0])


def test_engine_validates_config():
    with pytest.raises(ValueError):
        OthelloEngine(5)
    with pytest.raises(ValueError):
        OthelloEngine(8, "other")
    assert get_engine(6, "standard") is get_engine(6, "standard")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda:0")
