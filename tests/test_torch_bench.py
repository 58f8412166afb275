"""The port's bench (``othello_reinforcement_learning_test_tpu_torch/bench.py``)
on the CPU at a tiny size: each mode prints one JSON line with the keys of
the JAX package's ``bench.py``, and the bench refuses what needs the card.
Numbers from a CPU run are not device metrics; only the shape of the line is
checked here.
"""

import json
import sys

import pytest
import torch

from othello_reinforcement_learning_test_tpu_torch import bench
from othello_reinforcement_learning_test_tpu_torch.utils import config

# 4x4 boards keep the games short (about 16 plies)
TINY = ["--device", "cpu", "--repeats", "1", "--size", "4", "--blocks", "1", "--filters", "8",
        "--simulations", "2"]
RANDOM_KEYS = {"metric", "value", "unit", "vs_baseline", "env_steps_per_sec", "batch",
               "avg_moves", "wall_s"}
MCTS_KEYS = {"metric", "value", "unit", "vs_baseline", "env_steps_per_sec", "nn_sims_per_sec",
             "batch", "num_simulations", "model", "net_variant", "wall_s", "max_moves",
             "avg_moves"}
TRAIN_KEYS = {"metric", "value", "unit", "vs_baseline", "episodes", "num_simulations", "model",
              "net_variant"}


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The trainer's MetricsWriter writes TensorBoard files only when it
    imports, which would pull in tensorflow (tens of seconds) here."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def one_line(capsys, argv):
    assert bench.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.mark.parametrize("mode,keys,metric", [
    ("random", RANDOM_KEYS, "selfplay_games_per_sec"),
    ("mcts", MCTS_KEYS, "mcts_selfplay_games_per_sec"),
    ("train", TRAIN_KEYS, "train_iteration_seconds"),
])
def test_each_mode_prints_one_line(capsys, mode, keys, metric):
    out = one_line(capsys, ["--mode", mode, "--batch", "8", *TINY])
    assert set(out) == keys | {"device"}
    assert out["metric"] == metric and out["device"] == "cpu"
    assert out["value"] > 0
    if mode != "random":
        assert out["model"] == "1x8" and out["net_variant"] == "xla"
    if mode == "mcts":
        assert out["batch"] == 8 and out["num_simulations"] == 2
        assert out["avg_moves"] <= out["max_moves"]


def test_all_mode_combines_the_three(capsys):
    out = one_line(capsys, ["--batch", "4", *TINY])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "modes", "device"}
    assert out["metric"] == "alphazero_suite_mcts_games_per_sec"
    assert set(out["modes"]) == {"random", "mcts", "train"}
    assert set(out["modes"]["mcts"]) == MCTS_KEYS
    assert out["value"] == out["modes"]["mcts"]["value"]
    assert out["modes"]["mcts"]["net_variant"] == "xla"  # int8_dx3 only on the card


@pytest.mark.parametrize("variant", ["int8", "int8_xla", "int8_dx3", "matmul9"])
def test_mcts_net_variants_on_the_cpu(capsys, variant):
    """Every --net-variant runs (the kernels' plain versions on the CPU)."""
    out = one_line(capsys, ["--mode", "mcts", "--batch", "2", "--net-variant", variant, *TINY])
    assert out["net_variant"] == variant and out["batch"] == 2


def test_net_variants_are_bench_pys():
    """The same --net-variant choices as the JAX package's bench.py."""
    assert bench.NET_VARIANTS == ("xla", "matmul9", "int8", "int8_dx3", "int8_xla")
    with pytest.raises(SystemExit):
        bench.parse_args(["--net-variant", "int8_bf16"])


def test_pallas_needs_the_card():
    with pytest.raises(ValueError, match="card"):
        bench.run(["--mode", "random", "--pallas", *TINY])


def test_no_fallback_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(["--mode", "random"])


def test_default_flags():
    args = bench.parse_args([])
    assert (args.mode, args.repeats, args.size, args.simulations) == ("all", 3, 8, 25)
    assert (args.blocks, args.filters, args.batch, args.pallas) == (10, 128, None, None)


def test_config_defaults_match_the_jax_package():
    from othello_reinforcement_learning_test_tpu.utils.config import DEFAULTS

    assert config.load_config() == DEFAULTS
    assert config.load_config() is not config.DEFAULTS
