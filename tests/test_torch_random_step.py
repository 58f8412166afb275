"""The port's random-play step (``kernels/random_step.py``,
``ops/fused_step.py``) against the JAX package's Pallas step
(``ops/pallas_step.py``) run in interpret mode on the CPU.

Both sides get the same random words (the JAX function draws them from its
key with ``jax.random.bits``; the test draws the same bits from the same key
and hands them to the port), so boards, ``live``, steps and plies must be
equal bit for bit: integer work, no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.ops import bits as jbits
from othello_reinforcement_learning_test_tpu.ops import pallas_step as jps
from othello_reinforcement_learning_test_tpu.ops.bitboard import get_engine as jax_engine
from othello_reinforcement_learning_test_tpu_torch.kernels import random_step as rs
from othello_reinforcement_learning_test_tpu_torch.ops import fused_step as fs
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine

from torch_stub_net import random_boards, to_i64


def jax_words(key, shape):
    return np.array(jax.random.bits(key, (2, *shape), dtype=jnp.uint32))


def packed_pair(me_words, opp_words):
    """uint64 numpy words -> (JAX packed, port packed), each (4, R, 128)."""
    j = jps.pack_boards(jnp.asarray(jbits.from_uint64_np(me_words)),
                        jnp.asarray(jbits.from_uint64_np(opp_words)))
    t = fs.pack_boards(torch.from_numpy(me_words.view(np.int64)),
                       torch.from_numpy(opp_words.view(np.int64)))
    return j, t


def assert_step_equal(j_packed, t_packed, key, size=8, rules="reference"):
    j_new, j_live = jps.random_step(j_packed, key, size=size, rules=rules, interpret=True)
    words = torch.from_numpy(jax_words(key, j_packed.shape[1:]))
    t_new, t_live = rs.random_step(t_packed, words, size=size, rules=rules)
    np.testing.assert_array_equal(t_new.numpy(), np.asarray(j_new))
    np.testing.assert_array_equal(t_live.numpy(), np.asarray(j_live))
    return t_new, t_live


def test_pack_unpack_match_jax():
    s, tb = random_boards(8, "reference", 256, 10, seed=0)
    j = jps.pack_boards(s.me, s.opp)
    t = fs.pack_boards(tb.me, tb.opp)
    assert t.dtype == torch.uint32 and t.shape == (4, 2, 128)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    me, opp = fs.unpack_boards(t)
    assert torch.equal(me, tb.me) and torch.equal(opp, tb.opp)
    with pytest.raises(ValueError):
        fs.pack_boards(tb.me[:100], tb.opp[:100])


# the other three (size, rules) pairs play whole games against JAX below
@pytest.mark.parametrize("size,rules", [(8, "standard"), (6, "standard"), (4, "reference")])
def test_opening_step_matches_jax(size, rules):
    s = jax_engine(size, rules).initial_state((128,))
    j = jps.pack_boards(s.me, s.opp)
    t = fs.pack_boards(torch.from_numpy(to_i64(s.me)), torch.from_numpy(to_i64(s.opp)))
    t_new, t_live = assert_step_equal(j, t, jax.random.PRNGKey(31), size, rules)
    assert bool((t_live == 1).all())
    # one stone placed on a legal, on-board square
    eng = get_engine(size, rules)
    me, opp = fs.unpack_boards(t)
    me2, opp2 = fs.unpack_boards(t_new)
    placed = opp2 & ~(me | opp)
    assert bool(((placed != 0) & ((placed & (placed - 1)) == 0)).all())
    assert bool(((placed & eng.legal_squares(me, opp)) != 0).all())


@pytest.mark.parametrize("size,rules", [(8, "reference"), (6, "standard")])
def test_midgame_steps_match_jax(size, rules):
    """Random positions 0-40 plies deep, passes and ends included."""
    n = 128
    s, _ = random_boards(size, rules, n, 2 * size, seed=size)
    j = jps.pack_boards(s.me, s.opp)
    t = fs.pack_boards(torch.from_numpy(to_i64(s.me)), torch.from_numpy(to_i64(s.opp)))
    key = jax.random.PRNGKey(size)
    for _ in range(3):
        key, sub = jax.random.split(key)
        t, _ = assert_step_equal(j, t, sub, size, rules)
        j = jnp.asarray(t.numpy())


def test_forced_move_matches_jax():
    """me on C1, opp on B1: A1 is the only move."""
    j, t = packed_pair(np.full(128, 1 << 2, np.uint64), np.full(128, 1 << 1, np.uint64))
    t_new, live = assert_step_equal(j, t, jax.random.PRNGKey(5))
    me2, opp2 = fs.unpack_boards(t_new)
    assert bool((me2 == 0).all()) and bool((opp2 == 0b111).all())
    assert bool((live == 1).all())


def test_pass_matches_jax():
    """me on A2 cannot move; opp on A1 can (A3): the side to move passes."""
    j, t = packed_pair(np.full(128, 1 << 8, np.uint64), np.full(128, 1, np.uint64))
    t_new, live = assert_step_equal(j, t, jax.random.PRNGKey(6))
    me2, opp2 = fs.unpack_boards(t_new)
    assert bool((me2 == 1).all()) and bool((opp2 == 1 << 8).all())
    assert bool((live == 1).all())


def test_terminal_passes_through_matches_jax():
    """me on A1, opp on B1..G1: neither side can move under the reference
    rules; the board passes through with live 0."""
    j, t = packed_pair(np.full(128, 1, np.uint64),
                       np.full(128, sum(1 << i for i in range(1, 7)), np.uint64))
    t_new, live = assert_step_equal(j, t, jax.random.PRNGKey(9))
    assert bool((live == 0).all())
    assert torch.equal(t_new, t)


@pytest.mark.parametrize("size,rules,seed", [(8, "reference", 7), (6, "reference", 3),
                                             (4, "standard", 3)])
def test_play_random_games_matches_jax(size, rules, seed):
    """Whole games at R=1, the port fed JAX's per-ply words: equal final
    boards, env steps and plies."""
    s = jax_engine(size, rules).initial_state((128,))
    j = jps.pack_boards(s.me, s.opp)
    max_plies = 2 * size * size + 4
    j_final, j_steps, j_plies = jps.play_random_games(
        j, jnp.int32(seed), max_plies=max_plies, size=size, rules=rules, interpret=True)

    keys = [jax.random.PRNGKey(seed)]

    def words(ply):
        assert ply == len(keys) - 1
        key, sub = jax.random.split(keys[-1])
        keys.append(key)
        return torch.from_numpy(jax_words(sub, (1, 128)))

    t = torch.from_numpy(np.array(j))
    t_final, t_steps, t_plies = fs.play_random_games(
        t, None, max_plies=max_plies, size=size, rules=rules, words=words)
    np.testing.assert_array_equal(t_final.numpy(), np.asarray(j_final))
    assert (t_steps, t_plies) == (int(j_steps), int(j_plies))
    me, opp = fs.unpack_boards(t_final)
    eng = get_engine(size, rules)
    assert bool(((eng.legal_squares(me, opp) == 0) & (eng.legal_squares(opp, me) == 0)).all())


def test_play_random_games_stops_at_max_plies():
    t = fs.pack_boards(*get_engine(8).initial_state((128,))[:2])
    g = torch.Generator().manual_seed(0)
    _, steps, plies = fs.play_random_games(t, g, max_plies=5)
    assert (steps, plies) == (5 * 128, 5)


def test_mod64_is_exact():
    rng = np.random.default_rng(0)
    lo = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    hi = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    lo[:4] = [0, 2 ** 32 - 1, 0, 2 ** 32 - 1]
    hi[:4] = [0, 0, 2 ** 32 - 1, 2 ** 32 - 1]
    for n in (1, 2, 3, 5, 7, 13, 16, 31, 32, 33, 64):
        got = rs.mod64(torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(hi.astype(np.int64)),
                       torch.full((4096,), n, dtype=torch.int64))
        want = (hi.astype(object) * (1 << 32) + lo.astype(object)) % n
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_kth_set_bit():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2 ** 63, 512, dtype=np.int64) * np.where(rng.random(512) < 0.5, 1, -1)
    words[:3] = [0, -1, 1 << 62]
    x = torch.from_numpy(words)
    u = words.view(np.uint64)
    for k in (0, 1, 5, 31, 32, 63):
        got = rs.kth_set_bit(x, torch.full((512,), k, dtype=torch.int64)).numpy().view(np.uint64)
        for w, g in zip(u, got):
            set_bits = [i for i in range(64) if int(w) >> i & 1]
            want = (1 << set_bits[k]) if k < len(set_bits) else None
            if want is not None:
                assert int(g) == want
        assert got[0] == 0  # no set bit: no move


def test_wrapper_refuses_bad_input():
    t = fs.pack_boards(*get_engine(8).initial_state((128,))[:2])
    with pytest.raises(ValueError):
        rs.random_step(t.view(torch.int32), torch.zeros((2, 1, 128), dtype=torch.uint32))
    with pytest.raises(ValueError):
        rs.random_step(t, torch.zeros((2, 2, 128), dtype=torch.uint32))
