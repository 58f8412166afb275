"""The port's native-engine binding and its three scripts against the JAX
package and the root scripts.

- ``NativeBoard`` against the JAX package's ``NativeBoard`` over seeded
  random games under both rule sets: legal bits and moves, move results,
  terminal flags, winners, counts, ``get_tensor_input``,
  ``get_symmetries`` and ``to_string``, all exact (both drive one C++
  engine, ``csrc/othello_native.cpp``, built by each package's own
  loader). Skipped where the JAX native tests skip: no C++ compiler.
- ``random_playout_benchmark``: equal counts for equal seeds.
- ``benchmark_ai`` and ``learning_curve`` of the port on tiny port
  checkpoints (2 blocks x 16 filters, ``--device cpu``, 2 games, 2
  simulations): their JSON artifacts have the root scripts' keys. The root
  scripts run with their players and matches stubbed: their keys, not
  their games, are the contract, and their JAX matches would spend most of
  a minute compiling.
- ``benchmark.py``: both sections at a tiny size.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu import evaluation as jevaluation
from othello_reinforcement_learning_test_tpu.evaluation.arena import MatchResult, MatchSummary
from othello_reinforcement_learning_test_tpu.ops import bitboard as jbb
from othello_reinforcement_learning_test_tpu.ops import native as jnative
from othello_reinforcement_learning_test_tpu_torch import benchmark, benchmark_ai, learning_curve
from othello_reinforcement_learning_test_tpu_torch.ops import native
from othello_reinforcement_learning_test_tpu_torch.train.trainer import AlphaZeroTrainer

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


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """MetricsWriter writes TensorBoard files only when it imports; here
    that would pull in tensorflow (tens of seconds)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture
def both_native():
    if not (jnative.available() and native.available()):
        pytest.skip("no C++ toolchain available")


def root_script(name: str):
    """A root script of the repository, imported as a module."""
    spec = importlib.util.spec_from_file_location(f"root_{name}", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the native engine ---------------------------------------------------------------


def assert_boards_equal(b, jb, pi):
    assert (b.self_board, b.opp_board, b.move_count, b.passed) == (
        jb.self_board, jb.opp_board, jb.move_count, jb.passed)
    assert b.get_legal_moves_bits() == jb.get_legal_moves_bits()
    assert b.get_legal_moves() == jb.get_legal_moves()
    assert b.is_terminal() == jb.is_terminal()
    assert b.get_winner() == jb.get_winner()
    assert b.get_stone_counts() == jb.get_stone_counts()
    t, jt = b.get_tensor_input(), jb.get_tensor_input()
    assert t.dtype == jt.dtype == np.float32 and np.array_equal(t, jt)
    for (f, p), (jf, jp) in zip(b.get_symmetries(pi), jb.get_symmetries(pi), strict=True):
        assert np.array_equal(f, jf) and np.array_equal(p, jp)
    assert b.to_string() == jb.to_string() == repr(b)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rules", ["reference", "standard"])
def test_native_board_matches_jax(rules, seed, both_native):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        b, jb = native.NativeBoard(rules), jnative.NativeBoard(rules)
        assert b.rules == rules
        while True:
            pi = rng.random(65).astype(np.float32)
            assert_boards_equal(b, jb, pi)
            if b.is_terminal():
                break
            illegal = [p for p in range(66) if p not in b.get_legal_moves()]
            bad = int(rng.choice(illegal))
            assert b.make_move(bad) == jb.make_move(bad) is False
            before = b.copy()
            move = int(rng.choice(b.get_legal_moves()))
            assert b.make_move(move) is jb.make_move(move) is True
            assert before.move_count == b.move_count - 1  # the copy stayed
        b.reset()
        jb.reset()
        assert_boards_equal(b, jb, pi)


@pytest.mark.parametrize("rules", ["reference", "standard"])
def test_random_playouts_match_jax(rules, both_native):
    keys = ("games", "moves", "black_wins", "white_wins", "draws")
    for seed in (1, 2):
        port = native.random_playout_benchmark(300, seed=seed, rules=rules)
        ref = jnative.random_playout_benchmark(300, seed=seed, rules=rules)
        assert sorted(port) == sorted(ref)
        assert [port[k] for k in keys] == [ref[k] for k in keys]
        assert port["black_wins"] + port["white_wins"] + port["draws"] == 300


# -- the scripts ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Two untrained 2x16 port checkpoints, ``checkpoint_iter_000001.pt`` and
    ``..._000002.pt``."""
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    tmp = tmp_path_factory.mktemp("tools")
    cfg = {"model": {"num_blocks": 2, "num_filters": 16}, "training": {"replay_buffer_size": 256},
           "paths": {"checkpoint_dir": str(tmp / "models"), "log_dir": str(tmp / "logs")}}
    try:
        tr = AlphaZeroTrainer(cfg, log_cb=None, device="cpu")
        for i in (1, 2):
            tr.save_checkpoint(f"checkpoint_iter_{i:06d}")
        tr.close()
    finally:
        mp.undo()
    return tmp / "models"


def fake_summary(player1, player2, num_games):
    results = [MatchResult(player1=player1, player2=player2, winner=1, player1_score=40,
                           player2_score=24, num_moves=60, duration=0.1, player1_color="black")
               for _ in range(num_games)]
    return MatchSummary(player1=player1, player2=player2, wins=num_games, losses=0, draws=0,
                        win_rate=1.0, avg_score=40.0, avg_moves=60.0, duration=0.1,
                        results=results)


@pytest.fixture
def stubbed_jax(monkeypatch):
    """The JAX package's players and matches as stubs: the root scripts'
    control flow and artifacts, without their compiles."""
    engine = jbb.get_engine(8, "reference")

    def from_checkpoint(path, num_simulations=50, engine=None):
        return argparse.Namespace(engine=jbb.get_engine(8, "reference"), name="MCTS")

    def play_matches(self, player1, player2, num_games, rng, opening_random_plies=0):
        return fake_summary(player1.name, player2.name, num_games)

    def evaluate_player(player, opponent, engine, num_games=20, **kw):
        s = fake_summary(player.name, opponent.name, num_games)
        return {"opponent": opponent.name, "num_games": num_games, "wins": s.wins,
                "losses": s.losses, "draws": s.draws, "win_rate": s.win_rate,
                "avg_score": s.avg_score, "avg_moves": s.avg_moves, "results": s.results}

    monkeypatch.setattr(jevaluation.MCTSPlayer, "from_checkpoint", from_checkpoint)
    monkeypatch.setattr(jevaluation.Arena, "play_matches", play_matches)
    monkeypatch.setattr(jevaluation, "evaluate_player", evaluate_player)
    monkeypatch.setattr(jevaluation, "NativeMinimaxPlayer",
                        lambda engine, depth: argparse.Namespace(name="Minimax"))
    return engine


def key_tree(obj):
    """The nested keys of a JSON object (lists: their first element's)."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [key_tree(obj[0])] if obj else []
    return None


def test_benchmark_ai_has_the_jax_keys(checkpoints, tmp_path, monkeypatch, stubbed_jax, capsys):
    ckpt = str(checkpoints / "checkpoint_iter_000001.pt")
    port_path = benchmark_ai.main(["--checkpoint", ckpt, "--games", "2", "--simulations", "2",
                                   "--device", "cpu", "--output-dir", str(tmp_path / "port")])
    port = json.load(open(port_path))
    monkeypatch.setattr(sys, "argv", ["benchmark_ai.py", "--checkpoint", ckpt, "--games", "2",
                                      "--output-dir", str(tmp_path / "jax")])
    root_script("benchmark_ai").main()
    (ref_name,) = os.listdir(tmp_path / "jax")
    ref = json.load(open(tmp_path / "jax" / ref_name))
    assert key_tree(port) == key_tree(ref)
    assert sorted(port["results"]) == sorted(port["deterministic_results"]) == ["Greedy", "Random"]
    row = port["results"]["Random"]
    assert row["wins"] + row["losses"] + row["draws"] == 2
    assert row["score_min"] <= row["avg_score"] <= row["score_max"]
    assert port["opening_random_plies"] == 4 and "report saved to" in capsys.readouterr().out


def test_learning_curve_has_the_jax_keys(checkpoints, tmp_path, monkeypatch, stubbed_jax,
                                         capsys):
    out = tmp_path / "port.json"
    learning_curve.main(["--checkpoint-dir", str(checkpoints), "--games", "2", "--simulations",
                         "2", "--device", "cpu", "--minimax-depth", "1", "--anchor-checkpoint",
                         str(checkpoints / "checkpoint_iter_000001.pt"), "--output", str(out)])
    port = json.load(open(out))
    table = capsys.readouterr().out
    jdir = tmp_path / "orbax"
    for i in (1, 2):
        (jdir / f"checkpoint_iter_{i:06d}").mkdir(parents=True)
    monkeypatch.setattr(sys, "argv", [
        "learning_curve.py", "--checkpoint-dir", str(jdir), "--games", "2", "--minimax-depth",
        "1", "--anchor-checkpoint", "anchor", "--output", str(tmp_path / "jax.json")])
    root_script("learning_curve").main()
    ref = json.load(open(tmp_path / "jax.json"))
    assert key_tree(port) == key_tree(ref)
    assert [r["iteration"] for r in port["curve"]] == [r["iteration"] for r in ref["curve"]]
    assert table.splitlines()[0] == capsys.readouterr().out.splitlines()[0]
    assert all(0.0 <= r["win_rate_vs_minimax"] <= 1.0 for r in port["curve"])


def test_benchmark_sections(capsys, both_native):
    out = benchmark.main(["--games", "300", "--batch", "32", "--repeats", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    n, b = out["native"], out["batched"]
    assert n["games"] == 300 and n["passed"] == (n["games_per_sec"] >= benchmark.PASS_BAR)
    assert n["legal_moves_per_sec"] > 0 and n["copy_per_sec"] > 0
    assert b["batch"] == 32 and b["value"] > 0 and 0 < b["avg_moves"] <= 64
    assert "reference pass bar (5,000 games/sec)" in text and "batched tensor engine on cpu" in text
    assert benchmark.main(["--games", "10", "--skip-batched"])["batched"] is None


def test_scripts_need_cuda_unless_cpu(checkpoints):
    if torch.cuda.is_available():
        pytest.skip("a card is present: auto runs on it")
    ckpt = str(checkpoints / "checkpoint_iter_000001.pt")
    for run in (lambda: benchmark_ai.main(["--checkpoint", ckpt]),
                lambda: learning_curve.main(["--checkpoint-dir", str(checkpoints)]),
                lambda: benchmark.bench_batched(8, 1, "auto")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
