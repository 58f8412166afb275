"""PyTorch port of batched self-play against the JAX package.

Both sides get the same stub network (``torch_stub_net.py``), or the same
int8 network, with ``add_noise=False`` and ``temperature_threshold=0``, so
every move is an argmax. Tolerances:

- boards, masks, values, move counts, stone counts and winners: exact;
- pi: atol 1e-6 (its normalizing sum is taken in another order).

JAX's random streams cannot be reproduced, so the temperature sampling is
tested by its properties.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.models.pallas_resnet import FusedInference as JaxFused
from othello_reinforcement_learning_test_tpu.models.resnet import OthelloResNet as JaxResNet
from othello_reinforcement_learning_test_tpu.ops import bitboard as jbb
from othello_reinforcement_learning_test_tpu.train import self_play as jsp
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import FusedInference
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from othello_reinforcement_learning_test_tpu_torch.train import self_play as tsp
from torch_stub_net import jax_stub, stub_weights, to_i64, torch_stub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's intra-op pool at one thread: the games here are long chains
    of tiny ops, which many threads per worker turn into spin-waits when
    the test workers share the cores (tens of times slower); one thread
    runs them as fast as eight does alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("size,rules", [(8, "reference"), (8, "standard"), (6, "reference")])
def test_play_games_matches_jax_with_stub_net(size, rules):
    weights = stub_weights(size, seed=size)
    jt = jsp.play_games(jbb.get_engine(size, rules), jax_stub, jax.tree.map(jnp.asarray, weights),
                        jax.random.PRNGKey(0), num_games=2, num_simulations=8,
                        temperature_threshold=0, add_noise=False)
    tt = tsp.play_games(get_engine(size, rules), torch_stub(weights), 2, 8,
                        temperature_threshold=0, add_noise=False, device="cpu")
    assert_same_trajectory(tt, jt)


def assert_same_trajectory(tt, jt):
    jt = jax.tree.map(np.asarray, jt)
    T = jt.mask.shape[1]
    assert tt.mask.shape == (jt.mask.shape[0], T)
    np.testing.assert_array_equal(tt.me.numpy(), to_i64(jt.me))
    np.testing.assert_array_equal(tt.opp.numpy(), to_i64(jt.opp))
    np.testing.assert_array_equal(tt.mask.numpy(), jt.mask)
    np.testing.assert_array_equal(tt.value.numpy(), jt.value)
    np.testing.assert_allclose(tt.pi.numpy(), jt.pi, atol=1e-6, rtol=0)
    for name in ("final_me_count", "final_opp_count", "winner_black", "num_moves"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), getattr(jt, name), err_msg=name)


def test_play_games_matches_jax_with_int8_net():
    """The slice as a whole: self-play through FusedInference (int8_dx3) at
    2 blocks x 128 against JAX ``play_games`` with the JAX FusedInference
    (int8_dx3, Pallas in interpret mode). The JAX network runs unfused, as a
    host callback: inside the jitted self-play loop XLA would elide the
    stem's and heads' bf16 roundings, which moves values by up to ~0.1
    through the int8 rounding cascade. Unfused, the two nets agree to about
    1e-7, far from the PUCT ties of this game."""
    variables = init_numpy_variables(2, 128, seed=21)
    jfused = JaxFused(JaxResNet(num_blocks=2, num_filters=128), interpret=True,
                      variant="int8_dx3")
    games = 4

    def host_net(x):
        lp, v = jfused(variables, jnp.asarray(x))
        return np.asarray(lp), np.asarray(v)

    def jax_net(_, x):
        shapes = (jax.ShapeDtypeStruct((games, 65), jnp.float32),
                  jax.ShapeDtypeStruct((games, 1), jnp.float32))
        return jax.pure_callback(host_net, shapes, x)

    jt = jsp.play_games(jbb.get_engine(8), jax_net, {}, jax.random.PRNGKey(0),
                        num_games=games, num_simulations=6, temperature_threshold=0,
                        add_noise=False)
    m = OthelloResNet(2, 128)
    m.load_state_dict(from_jax_variables(variables))
    tt = tsp.play_games(get_engine(8), FusedInference(m.eval()), games, 6,
                        temperature_threshold=0, add_noise=False, device="cpu")
    assert_same_trajectory(tt, jt)


def test_play_games_sampled_is_sane():
    """Noise and temperature sampling on: trajectories keep their invariants."""
    eng = get_engine(8)
    tt = tsp.play_games(eng, torch_stub(stub_weights(8)), 6, 4, temperature_threshold=15,
                        add_noise=True, seed=3, device="cpu")
    mask = tt.mask
    assert not bool((mask[:, 1:] & ~mask[:, :-1]).any())
    assert torch.allclose(tt.pi.sum(-1)[mask], torch.ones(int(mask.sum())), atol=1e-5)
    assert bool((tt.pi[~mask] == 0).all())
    assert set(tt.value.unique().tolist()) <= {-1.0, 0.0, 1.0}
    assert torch.equal(tt.num_moves, mask.sum(1).to(torch.int32))
    assert bool(((tt.final_me_count + tt.final_opp_count) <= 64).all())
    again = tsp.play_games(eng, torch_stub(stub_weights(8)), 6, 4, temperature_threshold=15,
                           add_noise=True, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tt, again))
    # the sampled openings differ between games
    assert len({int(w) for w in tt.me[:, 2]}) > 1


def test_play_games_requires_a_simulation():
    with pytest.raises(ValueError, match="num_simulations >= 1"):
        tsp.play_games(get_engine(8), torch_stub(stub_weights(8)), 2, 0, device="cpu")


@pytest.mark.parametrize("size", [4, 6, 8])
def test_max_game_length(size):
    assert tsp.max_game_length(size) == jsp.max_game_length(size)


def test_selfplay_worker_facade():
    w = tsp.SelfPlayWorker(get_engine(6), torch_stub(stub_weights(6)), num_simulations=3,
                           temperature_threshold=0, device="cpu")
    one = w.execute_episode(seed=0, add_noise=False)
    two = w.execute_episodes(2, seed=0, add_noise=False)
    assert one.mask.shape == (1, tsp.max_game_length(6))
    assert torch.equal(two.me[0], one.me[0]) and torch.equal(two.me[1], one.me[0])


def test_sampling_follows_probs_and_skips_zeros():
    probs = torch.tensor([[0.0, 0.5, 0.0, 0.3, 0.2]]).repeat(20000, 1)
    a = tsp._sample(probs, torch.Generator().manual_seed(1))
    freq = torch.bincount(a, minlength=5).float() / len(a)
    assert freq[0] == 0 and freq[2] == 0
    assert torch.allclose(freq, probs[0], atol=0.015)
    onehot = torch.nn.functional.one_hot(torch.arange(5), 5).float()
    assert torch.equal(tsp._sample(onehot, torch.Generator().manual_seed(2)), torch.arange(5))


def test_port_imports_no_jax():
    """The port and chip_smoke.py's imports load neither jax nor the JAX
    package (run in a fresh interpreter)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import othello_reinforcement_learning_test_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'yaml', 'pydantic', "
        "'othello_reinforcement_learning_test_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
