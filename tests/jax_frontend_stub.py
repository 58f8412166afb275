"""The JAX and port frontend sessions on the stub network of
``torch_stub_net.py``, for the tests that hold the port's frontends to the
JAX ones (``test_torch_web.py``, ``test_torch_gui.py``).

The JAX session runs its engine and search eagerly: on the CPU each AI move
recompiles the search's loops (about 5 s) and each state view dispatches
dozens of small ops (about 0.1 s). Here the JAX session gets the same
engine methods and the same search jitted, once per engine and simulation
count, which changes how they are dispatched and nothing they compute.
"""

import functools
import types

import jax

from othello_reinforcement_learning_test_tpu.apps.web import game_manager as jgm_lib
from othello_reinforcement_learning_test_tpu.evaluation.players import MCTSPlayer as JaxMCTSPlayer
from othello_reinforcement_learning_test_tpu.ops import bitboard as jbb
from othello_reinforcement_learning_test_tpu.search import mcts as jmcts
from othello_reinforcement_learning_test_tpu_torch.apps.web.game_manager import GameManager
from othello_reinforcement_learning_test_tpu_torch.evaluation.players import MCTSPlayer
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from torch_stub_net import jax_stub, stub_weights, torch_stub

WEIGHTS = stub_weights(8)
SIMULATIONS = 10  # the session's floor; the hint's is max(10, sims // 2) = 10 too


@functools.lru_cache(maxsize=None)
def _search(engine, num_simulations):
    return jax.jit(lambda variables, boards, rng: jmcts.search(
        engine, lambda x: jax_stub(variables, x), boards, rng,
        num_simulations=num_simulations, add_noise=False))


class _JittedEngine:
    """The JAX engine with the methods the session calls jitted."""

    def __init__(self, engine):
        self.raw = engine
        for name in ("legal_actions", "step", "is_terminal", "winner", "stone_counts"):
            setattr(self, name, jax.jit(getattr(engine, name)))

    def __getattr__(self, name):
        return getattr(self.raw, name)


class _StubPlayer(JaxMCTSPlayer):
    """The JAX MCTSPlayer (search, then the most visited legal action) on
    the stub network, its search jitted."""

    def act(self, rng, boards):
        res = _search(self.engine, self.num_simulations)(self.variables, boards, rng)
        return jmcts.best_action(res.visit_counts, res.legal)


def _hint_search(engine, apply_fn, boards, rng, num_simulations, add_noise=False):
    """The JAX session's hint search (``mcts.search`` on the loaded player's
    network, which is the stub on ``WEIGHTS`` here), jitted."""
    assert not add_noise
    return _search(engine.raw, num_simulations)(WEIGHTS, boards, rng)


def jit_jax_session(monkeypatch, gm) -> None:
    """Give a JAX ``GameManager`` its engine's methods and its hint search
    jitted."""
    monkeypatch.setattr(jgm_lib, "mcts", types.SimpleNamespace(
        search=_hint_search, action_evaluations=jmcts.action_evaluations))
    gm.engine = _JittedEngine(gm.engine)


def jax_session(monkeypatch, rules: str, model_dir: str):
    """A JAX ``GameManager`` (no model loaded), jitted."""
    gm = jgm_lib.GameManager(engine=jbb.get_engine(8, rules), model_dir=model_dir)
    jit_jax_session(monkeypatch, gm)
    return gm


def port_session(rules: str, model_dir: str) -> GameManager:
    """The port's ``GameManager`` on the CPU (no model loaded)."""
    return GameManager(engine=get_engine(8, rules), model_dir=model_dir, device="cpu")


def install_players(jax_gm, port_gm) -> None:
    """The stub player in both sessions, at ``SIMULATIONS``."""
    jax_gm._player = _StubPlayer(jax_gm.engine.raw, jax_stub, WEIGHTS)
    port_gm._player = MCTSPlayer(port_gm.engine, torch_stub(WEIGHTS))
    for gm in (jax_gm, port_gm):
        gm.set_simulations(SIMULATIONS)
