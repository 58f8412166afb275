"""PyTorch port of the batched MCTS against the JAX package.

Both searches get the same stub network (``torch_stub_net.py``) and the
same positions, with ``add_noise=False``. Tolerances:

- visit counts, legal masks, Q values, root values, best actions and hint
  evaluations: exact (the same exact leaf values summed once per slot);
- action probabilities and masked priors: atol 1e-6 (their normalizing sums
  are taken in another order).

JAX's random streams cannot be reproduced, so the Dirichlet noise is tested
by its properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.ops import bitboard as jbb
from othello_reinforcement_learning_test_tpu.search import mcts as jm
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from othello_reinforcement_learning_test_tpu_torch.search import mcts as tm
from torch_stub_net import jax_stub, random_boards, stub_weights, torch_stub


@pytest.mark.parametrize("size,rules,plies", [(8, "reference", 10), (8, "standard", 30),
                                              (6, "reference", 8), (8, "reference", 56)])
def test_search_matches_jax(size, rules, plies):
    weights = stub_weights(size)
    js, ts = random_boards(size, rules, 12, plies, seed=plies)
    jres = jm.search(jbb.get_engine(size, rules),
                     lambda x: jax_stub(jax.tree.map(jnp.asarray, weights), x),
                     js, jax.random.PRNGKey(0), num_simulations=16, c_puct=1.0)
    tres = tm.search(get_engine(size, rules), torch_stub(weights), ts, 16, c_puct=1.0)
    np.testing.assert_array_equal(tres.visit_counts.numpy(), np.asarray(jres.visit_counts))
    np.testing.assert_array_equal(tres.legal.numpy(), np.asarray(jres.legal))
    np.testing.assert_array_equal(tres.root_terminal.numpy(), np.asarray(jres.root_terminal))
    np.testing.assert_array_equal(tres.q_values.numpy(), np.asarray(jres.q_values))
    np.testing.assert_array_equal(tres.root_value.numpy(), np.asarray(jres.root_value))
    np.testing.assert_array_equal(tm.best_action(tres.visit_counts, tres.legal).numpy(),
                                  np.asarray(jm.best_action(jres.visit_counts, jres.legal)))
    np.testing.assert_array_equal(tm.action_evaluations(tres).numpy(),
                                  np.asarray(jm.action_evaluations(jres)))


def test_root_cache_reuse_is_exact():
    """A search rooted at a child, seeded from the parent tree's cache,
    equals a fresh search of that child."""
    eng = get_engine(8, "reference")
    net = torch_stub(stub_weights(8))
    _, boards = random_boards(8, "reference", 6, 12, seed=1)
    res, tree = tm.search(eng, net, boards, 12, return_tree=True)
    action = tm.best_action(res.visit_counts, res.legal)
    child, _ = eng.step(boards, action)
    cached = tm.search(eng, net, child, 12, root_cache=tm.extract_root_cache(tree, action))
    fresh = tm.search(eng, net, child, 12)
    for a, b in zip(cached, fresh):
        assert torch.equal(a, b)


def test_mcts_facade_matches_functional_search():
    eng = get_engine(8)
    net = torch_stub(stub_weights(8))
    _, boards = random_boards(8, "reference", 4, 6, seed=2)
    facade = tm.MCTS(eng, net, num_simulations=10)
    res = tm.search(eng, net, boards, 10)
    assert torch.equal(facade.get_best_action(boards), tm.best_action(res.visit_counts, res.legal))
    assert torch.equal(facade.get_action_evaluations(boards), tm.action_evaluations(res))
    probs = facade.get_action_probs(boards, temperature=1.0)
    assert torch.allclose(probs.sum(-1), torch.ones(4))


@pytest.mark.parametrize("temperature", [0.0, 0.05, 0.5, 1.0, "vector"])
def test_action_probs_from_counts_matches_jax(temperature):
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 9, (16, 65)).astype(np.float32)
    counts[3] = 0  # no visits: uniform over legal
    legal = rng.random((16, 65)) < 0.4
    legal[:, 0] = True
    t = rng.choice([0.0, 0.5, 1.0], 16).astype(np.float32) if temperature == "vector" else temperature
    ref = np.asarray(jm.action_probs_from_counts(jnp.asarray(counts), jnp.asarray(legal), jnp.asarray(t)))
    out = tm.action_probs_from_counts(torch.from_numpy(counts), torch.from_numpy(legal),
                                      torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_pi_targets_do_not_depend_on_summation_order():
    """At temperature 1 (the pi targets) the distribution is the same bits
    whatever order the counts are summed in, as on the card and the CPU:
    permuting the actions permutes the output exactly. Summed in float32,
    about half of these rows changed in their last bit."""
    rng = np.random.default_rng(0)
    counts = torch.from_numpy(rng.integers(0, 40, (512, 65)).astype(np.float32))
    legal = torch.from_numpy(rng.random((512, 65)) < 0.8)
    out = tm.action_probs_from_counts(counts, legal, 1.0)
    for seed in range(8):
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(65))
        assert torch.equal(out[:, perm], tm.action_probs_from_counts(counts[:, perm], legal[:, perm], 1.0))


def test_masked_probs_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((8, 65)).astype(np.float32)
    logits[2] = -200.0  # vanishing mass: uniform fallback
    log_p = logits - np.log(np.exp(logits.astype(np.float64)).sum(-1, keepdims=True)).astype(np.float32)
    legal = rng.random((8, 65)) < 0.3
    legal[:, 5] = True
    ref = np.asarray(jm.masked_probs(jnp.asarray(log_p), jnp.asarray(legal)))
    out = tm.masked_probs(torch.from_numpy(log_p), torch.from_numpy(legal)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_dirichlet_noise_properties():
    """Zero on illegal actions, sums to 1, and the mean mixes the prior and
    a uniform over legal actions with weight eps (E[Dir(alpha)] = 1/n)."""
    n_rows, eps, alpha = 20000, 0.25, 0.3
    legal = torch.zeros((n_rows, 65), dtype=torch.bool)
    legal[:, [3, 10, 20, 64]] = True
    prior = torch.zeros((n_rows, 65))
    prior[:, [3, 10, 20, 64]] = torch.tensor([0.7, 0.2, 0.1, 0.0])
    gen = torch.Generator().manual_seed(0)
    noisy = tm.add_dirichlet_noise(gen, prior, legal, alpha, eps)
    assert bool((noisy[~legal] == 0).all())
    assert torch.allclose(noisy.sum(-1), torch.ones(n_rows), atol=1e-5)
    expected = (1 - eps) * prior[0, [3, 10, 20, 64]] + eps / 4
    assert torch.allclose(noisy[:, [3, 10, 20, 64]].mean(0), expected, atol=0.01)
    again = tm.add_dirichlet_noise(torch.Generator().manual_seed(0), prior, legal, alpha, eps)
    assert torch.equal(noisy, again)
    assert torch.equal(tm.add_dirichlet_noise(gen, prior, legal, alpha, 0.0), prior)
