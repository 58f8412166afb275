"""PyTorch port of the replay buffer against the JAX package.

Trajectory batches are made from a numpy seed and fed to both. Tolerances:

- ``add`` / ``add_prioritized`` / ``update_priorities``: exact, every ring
  slot and every counter; the same scatter of the same values. The trash
  slot C takes every masked-out ply, a scatter with repeated indices whose
  winner neither framework specifies (it varies with the CPU thread count),
  and no draw reads it; so it is held only to that: it is slot C;
- ``statistics``: 1e-6 (float32 sums taken in another order);
- the samplers cannot reproduce JAX's random streams, so they are held to
  their distributions: no repeats once the buffer holds a batch, indices in
  range, frequencies proportional to priority^alpha by a chi-square test at
  p > 1e-3, importance weights <= 1 as the formula gives them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from othello_reinforcement_learning_test_tpu.train import buffer as jbuf
from othello_reinforcement_learning_test_tpu.train.self_play import Trajectory as JTraj
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import Board, get_engine
from othello_reinforcement_learning_test_tpu_torch.train import buffer as tbuf
from othello_reinforcement_learning_test_tpu_torch.train.self_play import Trajectory
from torch_stub_net import to_i64, to_pair

A = 65


def make_traj(games, plies, seed):
    """Random trajectories with prefix masks of random lengths."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, plies + 1, games)
    mask = np.arange(plies)[None, :] < lengths[:, None]
    me = rng.integers(-2 ** 63, 2 ** 63, (games, plies), dtype=np.int64)
    opp = rng.integers(-2 ** 63, 2 ** 63, (games, plies), dtype=np.int64)
    pi = rng.random((games, plies, A)).astype(np.float32)
    value = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (games, plies))
    zeros = np.zeros(games, np.int32)
    t = Trajectory(*map(torch.from_numpy, (me, opp, pi, value, mask)),
                   *(torch.from_numpy(zeros) for _ in range(4)))
    j = JTraj(me=jnp.asarray(to_pair(me)), opp=jnp.asarray(to_pair(opp)), pi=jnp.asarray(pi),
              value=jnp.asarray(value), mask=jnp.asarray(mask),
              final_me_count=zeros, final_opp_count=zeros, winner_black=zeros, num_moves=zeros)
    return t, j


def assert_same_buffer(tb, jb):
    jb = jax.device_get(jb)
    C = tb.capacity
    assert tb.value.shape == jb.value.shape == (C + 1,)
    np.testing.assert_array_equal(tb.me[:C].numpy(), to_i64(jb.me[:C]))
    np.testing.assert_array_equal(tb.opp[:C].numpy(), to_i64(jb.opp[:C]))
    np.testing.assert_array_equal(tb.pi[:C].numpy(), jb.pi[:C])
    np.testing.assert_array_equal(tb.value[:C].numpy(), jb.value[:C])
    assert (tb.cursor, tb.filled, tb.total_added) == (int(jb.cursor), int(jb.filled),
                                                      int(jb.total_added))


# (capacity, [(games, plies, seed), ...]): fill without wrap, ring wraps over
# several adds, and one batch holding more plies than the capacity
ADD_CASES = [(400, [(4, 30, 0)]), (64, [(3, 20, 1), (4, 20, 2), (2, 25, 3)]),
             (16, [(5, 12, 4)]), (16, [(1, 5, 5), (6, 12, 6)])]


@pytest.mark.parametrize("capacity,batches", ADD_CASES)
def test_add_matches_jax(capacity, batches):
    tb, jb = tbuf.create(capacity, A, device="cpu"), jbuf.create(capacity, A)
    for games, plies, seed in batches:
        t, j = make_traj(games, plies, seed)
        tb = tbuf.add(tb, t)
        jb = jbuf.add(jb, j)
        assert_same_buffer(tb, jb)
    assert tb.filled == min(tb.total_added, capacity)


@pytest.mark.parametrize("capacity,batches", ADD_CASES[1:])
def test_add_prioritized_and_update_match_jax(capacity, batches):
    tb = tbuf.create_prioritized(capacity, A, device="cpu")
    jb = jbuf.create_prioritized(capacity, A)
    rng = np.random.default_rng(capacity)
    for games, plies, seed in batches:
        t, j = make_traj(games, plies, seed)
        tb, jb = tbuf.add_prioritized(tb, t), jbuf.add_prioritized(jb, j)
        assert_same_buffer(tb, jb)
        np.testing.assert_array_equal(tb.priority[:capacity].numpy(),
                                      np.asarray(jb.priority)[:capacity])
        # distinct indices: with duplicates the scatter's winner is unspecified
        idx = rng.choice(capacity, 6, replace=False)
        td = (rng.standard_normal(6) * 2).astype(np.float32)
        tb = tbuf.update_priorities(tb, torch.from_numpy(idx), torch.from_numpy(td))
        jb = jbuf.update_priorities(jb, jnp.asarray(idx), jnp.asarray(td))
        np.testing.assert_array_equal(tb.priority[:capacity].numpy(),
                                      np.asarray(jb.priority)[:capacity])
        assert tb.max_priority == float(jb.max_priority)
        assert tb.alpha == float(jb.alpha)


@pytest.mark.parametrize("capacity,batches", ADD_CASES)
def test_statistics_match_jax(capacity, batches):
    tb, jb = tbuf.create(capacity, A, device="cpu"), jbuf.create(capacity, A)
    for games, plies, seed in batches:
        t, j = make_traj(games, plies, seed)
        tb, jb = tbuf.add(tb, t), jbuf.add(jb, j)
    ts, js = tbuf.statistics(tb), jax.device_get(jbuf.statistics(jb))
    assert set(ts) == set(js)
    for k in ts:
        np.testing.assert_allclose(ts[k], float(js[k]), rtol=0, atol=1e-6, err_msg=k)
    assert tbuf.get_statistics is tbuf.statistics
    assert tbuf.is_ready(tb, tb.filled) and not tbuf.is_ready(tb, tb.filled + 1)


def marked_buffer(capacity, filled, prioritized=False, seed=0):
    """A buffer whose value slot i holds i, so a draw's values are its
    indices; random legal-looking boards."""
    rng = np.random.default_rng(seed)
    mk = tbuf.create_prioritized if prioritized else tbuf.create
    b = mk(capacity, A, device="cpu")
    b.value = torch.arange(capacity + 1, dtype=torch.float32)
    b.me = torch.from_numpy(rng.integers(0, 2 ** 62, capacity + 1, dtype=np.int64))
    b.opp = torch.from_numpy(rng.integers(0, 2 ** 62, capacity + 1, dtype=np.int64)) & ~b.me
    b.filled = filled
    return b


def test_sample_without_replacement_when_full_enough():
    eng = get_engine(8)
    b = marked_buffer(50, 40)
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(50)
    for _ in range(400):
        feats, pi, v = tbuf.sample(b, gen, eng, 16)
        idx = v[:, 0].long()
        assert feats.shape == (16, 8, 8, 3) and pi.shape == (16, A) and v.shape == (16, 1)
        assert len(set(idx.tolist())) == 16  # no repeats
        assert int(idx.max()) < 40
        n = idx.shape[0]
        ref = eng.features(Board(b.me[idx], b.opp[idx], torch.zeros(n, dtype=torch.int32),
                                 torch.zeros(n, dtype=torch.bool)))
        assert torch.equal(feats, ref)
        np.add.at(counts, idx.numpy(), 1)
    assert chisquare(counts[:40]).pvalue > 1e-3


def test_sample_with_replacement_below_batch():
    b = marked_buffer(50, 5)
    feats, pi, v = tbuf.sample(b, torch.Generator().manual_seed(1), get_engine(8), 32)
    idx = v[:, 0].long()
    assert int(idx.max()) < 5 and len(set(idx.tolist())) <= 5


def test_sample_prioritized_by_distribution():
    C, filled = 40, 30
    b = marked_buffer(C, filled, prioritized=True)
    rng = np.random.default_rng(3)
    prio = np.zeros(C + 1, np.float32)
    prio[:filled] = rng.uniform(0.1, 3.0, filled)
    prio[5] = 0.0  # valid but never seen: the 1e-6 guard
    b.priority = torch.from_numpy(prio)
    gen = torch.Generator().manual_seed(2)
    counts = np.zeros(C + 1)
    p = np.where(np.arange(C + 1) < filled, prio, 0) ** np.float32(b.alpha)
    p[5] = 1e-6
    probs = p / p.sum()
    for _ in range(300):
        feats, pi, v, idx, w = tbuf.sample_prioritized(b, gen, get_engine(8), 64)
        assert torch.equal(v[:, 0].long(), idx)
        assert int(idx.max()) < filled
        expect = 1.0 / (filled * probs[idx.numpy()])
        np.testing.assert_allclose(w.numpy(), expect / expect.max(), rtol=1e-5)
        assert float(w.max()) == pytest.approx(1.0) and bool((w <= 1).all())
        np.add.at(counts, idx.numpy(), 1)
    keep = np.arange(filled) != 5
    q = probs[:filled][keep].astype(np.float64)
    expected = q / q.sum() * counts[:filled][keep].sum()
    assert counts[5] == 0
    assert chisquare(counts[:filled][keep], expected).pvalue > 1e-3


def test_add_is_in_place_and_clone_is_not():
    b = tbuf.create(32, A, device="cpu")
    snap = b.clone()
    t, _ = make_traj(2, 10, 7)
    assert tbuf.add(b, t) is b
    assert snap.filled == 0 and int(snap.value.abs().sum()) == 0
    restored = tbuf.from_state_dict(b.state_dict())
    assert restored.filled == b.filled and torch.equal(restored.pi, b.pi)
