"""Arena gating in the port's trainer (``othello_reinforcement_learning_test_tpu_torch/
train/trainer.py``): the cases of ``tests/test_gating.py`` on a tiny model on
the CPU.

Self-play plays the best network so far; the candidate replaces it only on
a decisive gate-match win rate at or above the threshold. Rigged gate
matches test the decision, resume and self-heal rollback; one real gate
match runs through ``int8_dxcat``'s plain trunk. The gating config's
defaults and errors are held to the JAX trainer's, on the same configs.
"""

import json
import os
import sys

import pytest
import torch

from othello_reinforcement_learning_test_tpu.train.trainer import (
    AlphaZeroTrainer as JaxTrainer,
)
from othello_reinforcement_learning_test_tpu.utils.config import load_config
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dxcat import (
    trunk_int8_dxcat,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import FusedInference
from othello_reinforcement_learning_test_tpu_torch.train import trainer as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATING_FIELDS = ("gating_enabled", "gating_games", "gating_threshold", "gating_interval",
                 "gating_sims", "gating_opening")


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The JSONL metrics stream is the contract; TensorBoard would pull in
    tensorflow (tens of seconds)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def gated_config(tmp_path, name, variant=None, **gating):
    cfg = {"game": {"size": 4, "rules": "reference"},
           "model": {"num_blocks": 1, "num_filters": 8, "board_size": 4},
           "training": {"batch_size": 16, "lr": 0.01, "num_iterations": 2,
                        "self_play_episodes_per_iter": 4, "train_epochs_per_iter": 2,
                        "checkpoint_interval": 2, "replay_buffer_size": 512,
                        "gating": {"enabled": True, "games": 4, "win_threshold": 0.55,
                                   "interval": 1, "num_simulations": 2,
                                   "opening_random_plies": 2, **gating}},
           "mcts": {"num_simulations": 2}, "self_play": {"temperature_threshold": 3},
           "system": {"seed": 7},
           "paths": {"checkpoint_dir": str(tmp_path / name / "models"),
                     "log_dir": str(tmp_path / name / "logs")}}
    if variant:
        cfg["system"]["self_play_net_variant"] = variant
    return cfg


def trainer(cfg, **kw):
    return ttr.AlphaZeroTrainer(cfg, device="cpu", compute_dtype=torch.float32,
                                log_cb=kw.pop("log_cb", None), **kw)


def states_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


class Rigged:
    """A gate-match summary with a fixed outcome."""

    def __init__(self, wins, losses, draws=0):
        self.wins, self.losses, self.draws = wins, losses, draws


@pytest.mark.parametrize("wins,losses,adopted", [(0, 4, False), (4, 0, True)])
def test_gating_decision(tmp_path, monkeypatch, wins, losses, adopted):
    """A rejected candidate keeps best; an adopted one becomes best. Either
    way training moved the candidate."""
    tr = trainer(gated_config(tmp_path, f"rig{wins}"))
    initial = {k: t.clone() for k, t in tr.best.items()}
    assert states_equal(initial, tr.model.state_dict())
    seeds = []
    monkeypatch.setattr(tr, "_gate_match", lambda seed: (
        seeds.append(seed) or (wins / (wins + losses), Rigged(wins, losses))))
    tr.train()
    tr.close()
    assert len(seeds) == 2 and seeds[0] != seeds[1]  # one gate match per iteration
    assert not states_equal(tr.model.state_dict(), initial)
    assert states_equal(tr.best, tr.model.state_dict() if adopted else initial)


def test_self_play_plays_the_best_network(tmp_path, monkeypatch):
    tr = trainer(gated_config(tmp_path, "sp"))
    monkeypatch.setattr(tr, "_gate_match", lambda seed: (0.0, Rigged(0, 4)))
    tr.train(num_iterations=1)
    seen = []
    make_net = tr._net
    monkeypatch.setattr(tr, "_net", lambda model: seen.append(model) or make_net(model))
    tr.selfplay_net()
    assert seen == [tr._best_model] and states_equal(tr._best_model.state_dict(), tr.best)
    assert not states_equal(tr.best, tr.model.state_dict())
    tr.close()


def test_gating_decisions_logged(tmp_path, monkeypatch):
    cfg = gated_config(tmp_path, "log")
    logs = []
    tr = trainer(cfg, log_cb=logs.append)
    monkeypatch.setattr(tr, "_gate_match", lambda seed: (0.75, Rigged(3, 1)))
    tr.train()
    tr.close()
    with open(os.path.join(cfg["paths"]["log_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    gating = [(r["tag"], r["value"], r["step"]) for r in rows if r["tag"].startswith("Gating/")]
    assert gating == [("Gating/win_rate", 0.75, 1), ("Gating/accepted", 1.0, 1),
                      ("Gating/win_rate", 0.75, 2), ("Gating/accepted", 1.0, 2)]
    assert sum("gating @ iter" in m and "3W-1L-0D" in m and "ADOPTED" in m for m in logs) == 2


def test_real_gate_match_runs_through_int8_dxcat(tmp_path):
    """No rigging: identical candidate and best, a real 4-game arena match
    through the int8_dxcat trunk, which on the CPU is its plain version."""
    tr = trainer(gated_config(tmp_path, "real", variant="int8_dxcat"))
    net = tr._net(tr.model)
    assert isinstance(net, FusedInference) and net.variant == "int8_dxcat"
    trunks = []
    trunk = FusedInference.trunk
    before = trunk_int8_dxcat.launches

    def spy(self, h):
        trunks.append(self.variant)
        return trunk(self, h)

    FusedInference.trunk = spy
    try:
        win_rate, s = tr._gate_match(0)
    finally:
        FusedInference.trunk = trunk
    assert 0.0 <= win_rate <= 1.0
    assert s.wins + s.losses + s.draws == 4 == len(s.results)
    assert trunks and set(trunks) == {"int8_dxcat"}
    assert trunk_int8_dxcat.launches == before  # the CPU runs the plain version
    assert win_rate == (s.wins / (s.wins + s.losses) if s.wins + s.losses else 0.5)
    tr.close()


def test_gating_survives_resume_and_config_wins(tmp_path, monkeypatch):
    cfg = gated_config(tmp_path, "resume")
    tr = trainer(cfg)
    monkeypatch.setattr(tr, "_gate_match", lambda seed: (1.0, Rigged(4, 0)))
    tr.train()
    tr.close()
    final = os.path.join(tr.checkpoint_dir, "final_model.pt")
    assert json.load(open(final + ".meta.json"))["has_best"]

    tr2 = trainer(gated_config(tmp_path, "resume"))
    tr2.load_checkpoint(final)
    assert states_equal(tr2.best, tr.best)
    tr2.close()

    # gating off in the config: the checkpoint's best network is ignored
    off = gated_config(tmp_path, "resume", enabled=False)
    logs = []
    tr3 = trainer(off, log_cb=logs.append)
    tr3.load_checkpoint(final)
    assert tr3.best is None and any("ignoring it" in m for m in logs)
    tr3.close()

    # gating on, a checkpoint without a best network: best is the candidate
    tr4 = trainer(gated_config(tmp_path, "ungated", enabled=False))
    tr4.train(num_iterations=1)
    tr4.close()
    plain = os.path.join(tr4.checkpoint_dir, "final_model.pt")
    assert not json.load(open(plain + ".meta.json"))["has_best"]
    tr5 = trainer(gated_config(tmp_path, "resume2"))
    tr5.load_checkpoint(plain)
    assert states_equal(tr5.best, tr5.model.state_dict())
    assert states_equal(tr5.best, tr4.model.state_dict())
    tr5.close()


def test_self_heal_rollback_restores_best(tmp_path, monkeypatch):
    """An iteration that fails after adopting a candidate rolls back to the
    snapshot taken at its start, best network included."""
    cfg = gated_config(tmp_path, "heal")
    cfg["training"]["checkpoint_interval"] = 10  # no checkpoint: the snapshot path
    logs = []
    tr = trainer(cfg, log_cb=logs.append)
    initial = {k: t.clone() for k, t in tr.best.items()}
    calls = []

    def failing_once(iteration):
        calls.append(iteration)
        if len(calls) == 1:
            tr.best = {k: t + 1 if t.is_floating_point() else t for k, t in tr.best.items()}
            raise RuntimeError("device lost")
        return None

    monkeypatch.setattr(tr, "run_gating", failing_once)
    tr.train(num_iterations=1)
    tr.close()
    assert calls == [1, 1]
    assert any("rolling back to the start of iteration 1" in m for m in logs)
    assert states_equal(tr.best, initial)


@pytest.mark.parametrize("which", ["strong_8x8", "minimal", "explicit"])
def test_gating_config_matches_jax_trainer(tmp_path, which):
    if which == "strong_8x8":
        cfg = load_config(os.path.join(REPO, "configs", "strong_8x8.yaml"))
    elif which == "minimal":
        cfg = {"training": {"gating": {"enabled": True}}}
    else:
        cfg = {"training": {"checkpoint_interval": 3, "gating": {
            "enabled": True, "games": 0, "win_threshold": 0.6, "num_simulations": 5,
            "opening_random_plies": 0}}, "mcts": {"num_simulations": 9}}
    # a tiny network and buffer: neither enters the gating settings
    cfg.setdefault("model", {}).update(num_blocks=1, num_filters=8)
    cfg["training"]["replay_buffer_size"] = 512
    cfg["paths"] = {"checkpoint_dir": str(tmp_path / "m"), "log_dir": str(tmp_path / "l")}
    want = JaxTrainer(cfg, log_cb=None)
    got = trainer(cfg)
    assert {f: getattr(got, f) for f in GATING_FIELDS} == \
        {f: getattr(want, f) for f in GATING_FIELDS}
    assert got.gating_enabled and (got.best is not None)
    want.close()
    got.close()


@pytest.mark.parametrize("gating", [True, "yes", 1])
def test_gating_must_be_a_mapping(tmp_path, gating):
    cfg = gated_config(tmp_path, "bad")
    cfg["training"]["gating"] = gating
    with pytest.raises(ValueError, match="training.gating must be a mapping"):
        JaxTrainer(cfg, log_cb=None)
    with pytest.raises(ValueError, match="training.gating must be a mapping"):
        trainer(cfg)
