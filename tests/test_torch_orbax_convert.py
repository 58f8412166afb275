"""``scripts/orbax_to_torch.py``: a JAX trainer checkpoint (orbax) becomes a
``.pt`` that the port's player and web session load.

A 1x8 JAX ``TrainState`` with weights and BatchNorm statistics from a numpy
seed is saved through the JAX checkpoint module and converted. The port's
state dict must equal ``from_jax_variables`` of the saved variables bit for
bit, and its f32 forward the JAX ``apply_eval`` at f32 on seeded boards
within atol 1e-5 (the bar of ``test_torch_model.py``: one network, two
summation orders).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.models import resnet as jresnet
from othello_reinforcement_learning_test_tpu.train import checkpoint as jckpt
from othello_reinforcement_learning_test_tpu.train import trainer as jtrainer
from othello_reinforcement_learning_test_tpu_torch.apps.web.game_manager import GameManager
from othello_reinforcement_learning_test_tpu_torch.evaluation.players import MCTSPlayer
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from othello_reinforcement_learning_test_tpu_torch.train import checkpoint as tckpt
from torch_stub_net import random_boards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "orbax_to_torch", os.path.join(REPO, "scripts", "orbax_to_torch.py"))
orbax_to_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(orbax_to_torch)

CFG = {"game": {"size": 8, "rules": "standard"}, "model": {"num_blocks": 1, "num_filters": 8},
       "training": {"lr": 0.01}}


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A saved JAX TrainState (step 7, iteration 2) and its variables."""
    variables = init_numpy_variables(1, 8, seed=5)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jtrainer.TrainState(
        params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jtrainer.make_optimizer(CFG).init(params), step=jnp.int32(7),
        iteration=jnp.int32(2))
    path = jckpt.save(str(tmp_path_factory.mktemp("jax") / "checkpoint_2"), state, CFG)
    return path, variables


def test_converted_checkpoint_matches_the_jax_network(jax_checkpoint, tmp_path):
    src, variables = jax_checkpoint
    dst = orbax_to_torch.convert(src, str(tmp_path / "model.pt"))
    saved = tckpt.load(dst)
    assert sorted(saved) == ["iteration", "model", "step"]
    assert (saved["step"], saved["iteration"]) == (7, 2)
    assert tckpt.load_config(dst) == CFG
    want = from_jax_variables(variables)
    assert saved["model"].keys() == want.keys()
    assert all(torch.equal(saved["model"][k], want[k]) for k in want)

    player = MCTSPlayer.from_checkpoint(dst, device="cpu")
    assert player.engine.rules == "standard" and player.train_state["step"] == 7
    jstates, _ = random_boards(8, "standard", 64, 20, seed=3)
    from othello_reinforcement_learning_test_tpu.ops.bitboard import get_engine as jget_engine

    x = np.array(jget_engine(8, "standard").features(jstates), np.float32)
    model = jresnet.OthelloResNet(num_blocks=1, num_filters=8, board_size=8, dtype=jnp.float32)
    lp_j, v_j = jtrainer.apply_eval(model)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        lp_t, v_t = player.model(torch.from_numpy(x), train=False, compute_dtype=torch.float32)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5, rtol=0)


def test_web_session_loads_the_converted_file(jax_checkpoint, tmp_path, capsys):
    src, _ = jax_checkpoint
    # the default output goes beside the source
    for suffix in ("", ".config.json"):
        os.symlink(src + suffix, tmp_path / f"checkpoint_2{suffix}")
    orbax_to_torch.main([str(tmp_path / "checkpoint_2")])
    dst = str(tmp_path / "checkpoint_2.pt")
    assert capsys.readouterr().out.strip() == dst
    gm = GameManager(engine=get_engine(8, "standard"), model_dir=str(tmp_path), device="cpu")
    assert gm.list_models() == [dst]  # not the orbax directory
    ok, err = gm.load_model(str(tmp_path / "checkpoint_2"))
    assert not ok and "scripts/orbax_to_torch.py" in err
    assert gm.load_model(dst) == (True, None)
    gm.set_simulations(10)
    assert gm.execute_ai_move() == (True, None)
    assert gm.state_dict()["move_count"] == 1


def test_help_says_what_is_not_carried():
    text = orbax_to_torch.build_parser().format_help()
    assert "not a run to resume" in text and "momentum" in text
    with pytest.raises(FileNotFoundError):
        orbax_to_torch.convert(os.path.join(REPO, "no_such_checkpoint"))
