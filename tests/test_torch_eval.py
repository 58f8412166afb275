"""The port's players and arena (``othello_reinforcement_learning_test_tpu_torch/
evaluation/``) against the JAX package on the CPU.

Inputs come from a numpy seed; the MCTS player searches with the stub
network of ``torch_stub_net.py`` (exact float32 logits and values), so both
packages see the same numbers. Tolerance: exact everywhere. Actions, match
results (every ``MatchResult`` field but ``duration``) and minimax moves
are integers, and the searches agree visit for visit
(``tests/test_torch_mcts.py``). JAX's random streams cannot be reproduced,
so the random player and the random openings are tested by legality and by
reproducibility for a seed.
"""

import os
import stat
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu import evaluation as jevaluation
from othello_reinforcement_learning_test_tpu.evaluation import arena as jarena
from othello_reinforcement_learning_test_tpu.evaluation import players as jplayers
from othello_reinforcement_learning_test_tpu.models.torch_bridge import infer_architecture
from othello_reinforcement_learning_test_tpu.ops import bitboard as jbb
from othello_reinforcement_learning_test_tpu_torch import evaluation
from othello_reinforcement_learning_test_tpu_torch.evaluation import (
    Arena,
    EdaxPlayer,
    GreedyPlayer,
    HumanPlayer,
    MCTSPlayer,
    NativeMinimaxPlayer,
    RandomPlayer,
    evaluate_player,
)
from othello_reinforcement_learning_test_tpu_torch.ops import native
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import Board, get_engine
from torch_stub_net import jax_stub, stub_weights, to_pair, torch_stub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(8, "reference"), (8, "standard"), (6, "reference"), (6, "standard")]


def positions(size, rules, seed=0, n=256):
    """``n`` positions in both packages' layouts after 0 to S*S random legal
    plies from a numpy seed (some finished), stepped by the port's engine
    (``tests/test_torch_engine.py`` holds it to the JAX engine)."""
    eng = get_engine(size, rules)
    rng = np.random.default_rng(seed)
    plies = torch.from_numpy(rng.integers(0, size * size + 1, n))
    ts = eng.initial_state((n,))
    for t in range(size * size):
        legal = eng.legal_actions(ts)
        a = torch.argmax(legal * torch.from_numpy(rng.random(legal.shape)), dim=-1)
        nxt, _ = eng.step(ts, a)
        ts = Board(*(torch.where(plies > t, x, o) for x, o in zip(nxt, ts)))
    js = jbb.Board(me=jnp.asarray(to_pair(ts.me.numpy())), opp=jnp.asarray(to_pair(ts.opp.numpy())),
                   move_count=jnp.asarray(ts.move_count.numpy()),
                   passed=jnp.asarray(ts.passed.numpy()))
    return js, ts


def jax_mcts(engine, size, sims):
    weights = jax.tree.map(jnp.asarray, stub_weights(size))
    return jplayers.MCTSPlayer(engine, jax_stub, weights, num_simulations=sims)


@pytest.mark.parametrize("size,rules", CASES)
def test_greedy_and_mcts_players_match_jax(size, rules):
    js, ts = positions(size, rules)
    jeng, teng = jbb.get_engine(size, rules), get_engine(size, rules)
    key = jax.random.PRNGKey(0)
    greedy = GreedyPlayer(teng).act(ts)
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.asarray(jplayers.GreedyPlayer(jeng).act(key, js)))
    mcts = MCTSPlayer(teng, torch_stub(stub_weights(size)), num_simulations=8).act(ts)
    np.testing.assert_array_equal(mcts.numpy(), np.asarray(jax_mcts(jeng, size, 8).act(key, js)))
    legal = teng.legal_actions(ts)
    rows = torch.arange(legal.shape[0])
    assert bool(legal[rows, greedy].all()) and bool(legal[rows, mcts].all())
    assert greedy.dtype == mcts.dtype == torch.int64


@pytest.mark.parametrize("rules", ["reference", "standard"])
def test_native_minimax_matches_jax(rules):
    js, ts = positions(8, rules, seed=1)
    got = NativeMinimaxPlayer(get_engine(8, rules), depth=2).act(ts)
    want = jplayers.NativeMinimaxPlayer(jbb.get_engine(8, rules), depth=2).act(
        jax.random.PRNGKey(0), js)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="8x8"):
        NativeMinimaxPlayer(get_engine(6, rules))


def test_native_binding_matches_the_tensor_engine():
    """``ops/native.py`` builds into the git-ignored ``_build/`` and agrees
    with the tensor engine's legal moves and flips."""
    js, ts = positions(8, "reference", seed=2)
    eng = get_engine(8, "reference")
    assert native.build().parent.name == "_build"
    legal_sq = eng.legal_squares(ts.me, ts.opp)
    me, opp = ts.me.numpy().view(np.uint64), ts.opp.numpy().view(np.uint64)
    for i in range(0, 256, 7):
        assert native.legal(int(me[i]), int(opp[i])) == int(legal_sq[i]) & (2 ** 64 - 1)
        for pos in range(64):
            if (int(me[i]) | int(opp[i])) >> pos & 1:
                continue  # the native engine flips nothing on an occupied square
            want = eng.flips(ts.me[i:i + 1], ts.opp[i:i + 1],
                             torch.tensor([1], dtype=torch.int64) << pos)
            assert native.flips(int(me[i]), int(opp[i]), pos) == int(want) & (2 ** 64 - 1)


def match_fields(summary):
    return [(r.player1, r.player2, r.winner, r.player1_score, r.player2_score, r.num_moves,
             r.player1_color) for r in summary.results]


@pytest.mark.parametrize("pair", ["greedy_vs_greedy", "mcts_vs_greedy"])
def test_arena_matches_jax(pair):
    size, rules, games = 6, "reference", 16
    jeng, teng = jbb.get_engine(size, rules), get_engine(size, rules)
    jg, tg = jplayers.GreedyPlayer(jeng), GreedyPlayer(teng)
    if pair == "greedy_vs_greedy":
        jp, tp = jg, tg
    else:
        jp = jax_mcts(jeng, size, 8)
        tp = MCTSPlayer(teng, torch_stub(stub_weights(size)), num_simulations=8)
    want = jarena.Arena(jeng).play_matches(jp, jg, games, jax.random.PRNGKey(0))
    got = Arena(teng, device="cpu").play_matches(tp, tg, games, seed=0)
    assert match_fields(got) == match_fields(want)
    for f in ("wins", "losses", "draws", "win_rate", "avg_score", "avg_moves"):
        assert getattr(got, f) == getattr(want, f), f
    assert {r.player1_color for r in got.results} == {"black", "white"}


def test_play_game_white_plays_one_game():
    eng = get_engine(8, "reference")
    g, r = GreedyPlayer(eng), RandomPlayer(eng)
    arena = Arena(eng, device="cpu")
    res_w = arena.play_game(g, r, seed=3, player1_color="white")
    assert res_w.player1_color == "white"
    assert res_w.player1 == g.name and res_w.player2 == r.name
    # the mirrored seating with the same seed: the same game, seen from the
    # other side
    res_m = arena.play_game(r, g, seed=3, player1_color="black")
    assert res_m.winner == -res_w.winner
    assert (res_m.player1_score, res_m.player2_score) == (res_w.player2_score,
                                                          res_w.player1_score)
    assert res_m.num_moves == res_w.num_moves > 0


def test_evaluate_player_contract():
    eng = get_engine(6, "reference")
    out = evaluate_player(GreedyPlayer(eng), RandomPlayer(eng), eng, num_games=4, device="cpu")
    assert set(out) == {"opponent", "num_games", "wins", "losses", "draws", "win_rate",
                        "avg_score", "avg_moves", "results"}
    assert out["num_games"] == 4 and out["opponent"] == "Random"
    assert out["wins"] + out["losses"] + out["draws"] == 4 == len(out["results"])
    assert evaluation.__all__ == jevaluation.__all__


def test_random_player_and_openings_legal_and_reproducible():
    eng = get_engine(8, "standard")
    _, ts = positions(8, "standard", seed=4)
    p = RandomPlayer(eng)
    a = p.act(ts, torch.Generator().manual_seed(5))
    assert torch.equal(a, p.act(ts, torch.Generator().manual_seed(5)))
    assert not torch.equal(a, p.act(ts, torch.Generator().manual_seed(6)))
    assert bool(eng.legal_actions(ts)[torch.arange(256), a].all())
    arena = Arena(eng, device="cpu")
    g = GreedyPlayer(eng)
    runs = [match_fields(arena.play_matches(g, g, 16, seed=s, opening_random_plies=4))
            for s in (7, 7, 8)]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    # without random openings a greedy pair replays one game per colour
    plain = match_fields(arena.play_matches(g, g, 16, seed=7))
    assert len(set(plain)) == 2 and len(set(runs[0])) > 2


@pytest.fixture(scope="module")
def fake_edax():
    paths = [os.path.join(REPO, "tests", f) for f in ("fake_edax.py", "fake_edax_variant.py")]
    for path in paths:
        st = os.stat(path)
        os.chmod(path, st.st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
    return paths


def test_edax_player_with_the_fake_engines(fake_edax, tmp_path):
    eng = get_engine(8, "standard")
    p = EdaxPlayer(eng, binary_path=fake_edax[0])
    assert p.name.startswith("Edax(L")
    boards = eng.initial_state((3,))
    # the fake plays the first legal move in row-major order: D3 = 19
    assert p.act(boards).tolist() == [19, 19, 19]
    s = Arena(eng, device="cpu").play_matches(p, GreedyPlayer(eng), 2, seed=0)
    assert s.wins + s.losses + s.draws == 2 and all(r.num_moves > 0 for r in s.results)
    p.close()
    # the variant dialect ("bestmove d3") parses with the default pattern
    v = EdaxPlayer(eng, binary_path=fake_edax[1])
    assert v.act(boards).tolist() == [19, 19, 19]
    v.close()
    # an engine that answers an illegal move falls back to the first legal one
    bad = tmp_path / "bad_edax"
    bad.write_text(f"#!{sys.executable}\nimport sys\n"
                   "for line in sys.stdin:\n"
                   "    if line.startswith('go'):\n"
                   "        print('Edax plays A1', flush=True)\n")
    bad.chmod(0o755)
    b = EdaxPlayer(eng, binary_path=str(bad))
    assert b.act(boards).tolist() == [19, 19, 19]
    b.close()


def test_edax_without_binary_plays_random(fake_edax):
    eng = get_engine(8, "standard")
    p = EdaxPlayer(eng, binary_path="/nonexistent/edax")
    assert p.name == "Edax(random-fallback)"
    _, ts = positions(8, "standard", seed=6)
    a = p.act(ts, torch.Generator().manual_seed(0))
    assert bool(eng.legal_actions(ts)[torch.arange(256), a].all())


def test_human_player_reads_input_fn():
    eng = get_engine(8, "reference")
    replies = iter(["nonsense", "0", "2,3"])  # invalid, illegal, then D3
    p = HumanPlayer(eng, input_fn=lambda prompt: next(replies))
    assert p.act(eng.initial_state((1,))).tolist() == [19]
    with pytest.raises(ValueError, match="one game"):
        p.act(eng.initial_state((2,)))


def test_mcts_player_from_port_checkpoint(tmp_path, monkeypatch):
    from othello_reinforcement_learning_test_tpu_torch.train import trainer as ttr

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = {"game": {"size": 6, "rules": "standard"},
           "model": {"num_blocks": 1, "num_filters": 8, "board_size": 6},
           "training": {"batch_size": 8, "num_iterations": 1, "self_play_episodes_per_iter": 2,
                        "train_epochs_per_iter": 1, "replay_buffer_size": 256},
           "mcts": {"num_simulations": 2}, "system": {"seed": 3},
           "paths": {"checkpoint_dir": str(tmp_path / "m"), "log_dir": str(tmp_path / "l")}}
    tr = ttr.AlphaZeroTrainer(cfg, device="cpu", compute_dtype=torch.float32, log_cb=None)
    tr.train()
    tr.close()
    player = MCTSPlayer.from_checkpoint(str(tmp_path / "m" / "final_model.pt"),
                                        num_simulations=4, device="cpu")
    assert (player.engine.size, player.engine.rules) == (6, "standard")
    assert player.train_state["iteration"] == 1
    assert all(torch.equal(t, tr.model.state_dict()[k])
               for k, t in player.model.state_dict().items())
    boards = player.engine.initial_state((2,))
    a = player.act(boards)
    assert bool(player.engine.legal_actions(boards)[torch.arange(2), a].all())


@pytest.mark.parametrize("name", ["ref_seed7.pt", "repo_seed2024.pt"])
def test_mcts_player_from_reference_checkpoint(name, tmp_path):
    path = os.path.join(REPO, "results", "parity_models", name)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    player = MCTSPlayer.from_checkpoint(path, num_simulations=4, device="cpu")
    m = player.model
    assert (m.num_blocks, m.num_filters, m.board_size) == infer_architecture(
        obj["model_state_dict"])
    assert all(torch.equal(t, obj["model_state_dict"][k]) for k, t in m.state_dict().items())
    assert player.config == obj["config"] and player.engine.size == m.board_size
    boards = player.engine.initial_state((2,))
    assert bool(player.engine.legal_actions(boards)[torch.arange(2), player.act(boards)].all())
    # a bare reference state dict loads too, by content, under the same suffix
    bare = tmp_path / "bare.pt"
    torch.save(obj["model_state_dict"], bare)
    alone = MCTSPlayer.from_checkpoint(str(bare), device="cpu")
    assert alone.config == {} and all(torch.equal(t, m.state_dict()[k])
                                      for k, t in alone.model.state_dict().items())
