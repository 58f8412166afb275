"""The port's span recorder and host-sync counter (``utils/profiling.py``)
and the spans of its search, engine and ply loops, on the CPU.

The recorder keeps nothing while off; on, spans nest by their parents,
carry their search call's id and are dropped past the recorder's bound. A
search on the 4x4 board has one span of each kind a call and four parts a
simulation, and gives the same bits with the recorder on as off. The
walk's counter and the ply loops' ``sync.live`` spans equal the loops'
liveness tests, worked out apart from them.
"""

import itertools

import pytest
import torch

from othello_reinforcement_learning_test_tpu_torch.evaluation.arena import Arena
from othello_reinforcement_learning_test_tpu_torch.evaluation.players import RandomPlayer
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from othello_reinforcement_learning_test_tpu_torch.search import mcts
from othello_reinforcement_learning_test_tpu_torch.train import self_play
from othello_reinforcement_learning_test_tpu_torch.utils import profiling
from torch_stub_net import stub_weights, torch_stub

SIZE, GAMES, SIMS = 4, 6, 3
PARTS = ["mcts.select", "mcts.step_leaf", "mcts.evaluate", "mcts.backup"]
BENCHMARK_SPANS = {"search", "forward", "engine"}  # the benchmark's own, around the program


def boards(eng, plies=2, seed=0):
    """Positions after ``plies`` random legal plies."""
    gen = torch.Generator().manual_seed(seed)
    b = eng.initial_state((GAMES,))
    for _ in range(plies):
        legal = eng.legal_actions(b).to(torch.float32)
        b, _ = eng.step(b, torch.multinomial(legal, 1, generator=gen)[:, 0])
    return b


def run_search(eng, net, root, sims=SIMS):
    gen = torch.Generator().manual_seed(3)
    return mcts.search(eng, net, root, sims, c_puct=1.25, add_noise=True, generator=gen,
                       return_tree=True)


@pytest.fixture
def ticking(monkeypatch):
    """The recorder's clock as a counter that adds 10 ns at each read."""
    clock = itertools.count(0, 10)
    monkeypatch.setattr(profiling.time, "time_ns", lambda: next(clock))


def test_off_keeps_no_span():
    eng = get_engine(SIZE)
    net = torch_stub(stub_weights(SIZE))
    with profiling.tracing() as rec:
        pass
    assert not profiling._on and profiling._recorder is None
    assert profiling.span("mcts.search", call=True) is profiling._OFF
    run_search(eng, net, boards(eng))
    self_play.play_games(eng, net, 2, 2, device="cpu")
    assert rec.spans == [] and rec.dropped == 0


def test_nested_spans_parents_self_times_calls_and_drops(ticking, monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 5)
    with profiling.tracing() as rec:
        with profiling.span("a", call=True):  # 0: opens call 1
            with profiling.span("b"):  # 1
                with profiling.span("c"):  # 2
                    pass
            with profiling.span("d"):  # 3
                pass
        with profiling.span("e"):  # 4: outside any call
            with profiling.span("f", call=True):  # past the bound: dropped
                with profiling.span("g"):  # dropped
                    pass
        with profiling.span("h"):  # dropped
            pass
    assert [(s.name, s.parent, s.call) for s in rec.spans] == [
        ("a", -1, 1), ("b", 0, 1), ("c", 1, 1), ("d", 0, 1), ("e", -1, 0)]
    assert rec.dropped == 3
    assert all(s.end_ns > s.start_ns for s in rec.spans)
    # each read ticks 10 ns: a opens at 0, b 10, c 20-30, b closes 40, d 50-60, a 70
    assert [(s.start_ns, s.end_ns) for s in rec.spans[:4]] == [(0, 70), (10, 40), (20, 30),
                                                               (50, 60)]
    s = rec.summary()
    assert s["a"]["count"] == 1 and s["a"]["total_s"] == 70e-9
    assert s["a"]["self_s"] == pytest.approx((70 - 30 - 10) * 1e-9)
    assert s["b"]["self_s"] == pytest.approx(20e-9) and s["c"]["self_s"] == s["c"]["total_s"]
    assert "3 spans dropped" in rec.report()
    rec.reset()
    assert rec.spans == [] and rec.dropped == 0


def test_host_bool_counts_and_spans():
    def site():
        pass

    site.syncs = 0
    assert profiling.host_bool(torch.tensor(True), "sync.test", site) is True
    with profiling.tracing() as rec:
        assert profiling.host_bool(torch.tensor([0, 0]).any(), "sync.test", site) is False
        assert profiling.host_bool(torch.tensor(True), "sync.other") is True
    assert site.syncs == 2 and [s.name for s in rec.spans] == ["sync.test", "sync.other"]


def test_search_spans_on_the_4x4_board():
    eng = get_engine(SIZE)
    net = torch_stub(stub_weights(SIZE))
    root = boards(eng)
    with profiling.tracing() as rec:
        run_search(eng, net, root)
    spans = rec.spans
    names = [s.name for s in spans]
    assert names.count("mcts.search") == 1 and names.count("mcts.root") == 1
    assert names.count("mcts.simulation") == SIMS
    assert spans[0].name == "mcts.search" and spans[0].parent == -1
    assert {s.call for s in spans} == {1}
    children = {i: [s.name for s in spans if s.parent == i] for i in range(len(spans))}
    assert children[0] == ["mcts.root"] + ["mcts.simulation"] * SIMS
    for i, s in enumerate(spans):
        if s.name == "mcts.simulation":
            assert children[i] == PARTS
        if s.name == "mcts.step_leaf":
            assert children[i] == ["engine.step", "engine.observe"]
        if s.name == "mcts.select":
            assert children[i] and set(children[i]) == {"sync.select"}
    root_span = names.index("mcts.root")
    assert children[root_span] == ["engine.observe"]
    assert not BENCHMARK_SPANS & set(names)
    assert rec.dropped == 0 and all(s.end_ns >= s.start_ns for s in spans)


def test_no_program_span_takes_a_benchmark_name():
    eng = get_engine(SIZE)
    net = torch_stub(stub_weights(SIZE))
    with profiling.tracing() as rec:
        self_play.play_games(eng, net, 2, 2, device="cpu")
        Arena(eng, device="cpu").play_matches(RandomPlayer(eng), RandomPlayer(eng), 2)
    names = {s.name for s in rec.spans}
    assert {"mcts.search", "engine.step", "sync.live", "sync.select"} <= names
    assert not BENCHMARK_SPANS & names
    assert all("." in n for n in names)


def walk_tests(sel):
    """The walk's liveness tests (``cond_interval`` 1), from where it
    stopped: a game walks one step a level it descends, and one more that
    finds an unexpanded edge (none when it stopped on a terminal node); the
    walk tests once before each step and once more to end."""
    steps = (sel.path_len - 1) + (~sel.is_term_leaf).to(torch.int64)
    return int(steps.max()) + 1


def test_select_syncs_equal_the_walk_tests():
    """The simulations of a search by hand, each walk's tests worked out
    from where its games stopped; the search's counter equals their sum."""
    eng = get_engine(SIZE)
    net = torch_stub(stub_weights(SIZE))
    root = boards(eng, plies=4, seed=1)
    sims = 8
    legal0, term0, win0, feats = eng.observe(root, with_features=True)
    log_p, v0 = net(feats)
    win0 = win0.to(torch.float32)
    tree = mcts._init_tree(sims + 1, root.me, root.opp, mcts.masked_probs(log_p, legal0),
                           legal0, term0, win0, torch.where(term0, win0, v0[:, 0]))
    zeros = torch.zeros_like(root.move_count)
    want = []
    for _ in range(sims):
        before = mcts._select.syncs
        sel = mcts._select(tree, 1.25)
        want.append(walk_tests(sel))
        assert mcts._select.syncs - before == want[-1]
        child, c_legal, c_term, c_win, f = mcts._step_leaf(eng, tree, sel, zeros)
        lp, v = net(f)
        mcts._expand_and_backup(tree, sel, child.me, child.opp, mcts.masked_probs(lp, c_legal),
                                c_legal, c_term, c_win, v[:, 0])
    assert max(want) > 2  # the trees grew past the root's children
    mcts._select.syncs = 0
    _, searched = mcts.search(eng, net, root, sims, c_puct=1.25, return_tree=True)
    assert mcts._select.syncs == sum(want)
    assert torch.equal(searched.children, tree.children)  # the same walks


def test_search_bits_equal_on_and_off():
    eng = get_engine(SIZE)
    net = torch_stub(stub_weights(SIZE))
    root = boards(eng)
    off_res, off_tree = run_search(eng, net, root)
    with profiling.tracing():
        on_res, on_tree = run_search(eng, net, root)
    for a, b in zip(off_res, on_res):
        assert torch.equal(a, b)
    for k, a in vars(off_tree).items():
        assert torch.equal(a, getattr(on_tree, k)), k
    off = self_play.play_games(eng, net, GAMES, 2, seed=5, device="cpu")
    with profiling.tracing():
        on = self_play.play_games(eng, net, GAMES, 2, seed=5, device="cpu")
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_ply_loops_span_their_liveness_tests():
    eng = get_engine(SIZE)
    net = torch_stub(stub_weights(SIZE))

    def live_tests(rec):
        return sum(s.name == "sync.live" for s in rec.spans)

    with profiling.tracing() as rec:
        traj = self_play.play_games(eng, net, GAMES, 2, seed=1, device="cpu")
    # one test a ply searched, and the one that finds no game live
    assert live_tests(rec) == int(traj.mask.any(0).sum()) + 1
    with profiling.tracing() as rec:
        s = Arena(eng, device="cpu").play_matches(RandomPlayer(eng), RandomPlayer(eng), GAMES)
    assert live_tests(rec) == max(r.num_moves for r in s.results) + 1
