"""The search's leaf step (``kernels/leaf_step.py``) on the CPU: its plain
version against the engine's own rules (``OthelloEngine.step`` left to
find the pass legality by its flood, then ``observe`` with features), the
wrapper's checks, and the build's registration. The kernel itself is held
to the plain version on the card (``tests/test_torch_cuda.py``)."""

from types import SimpleNamespace

import pytest
import torch

from othello_reinforcement_learning_test_tpu_torch.kernels import build
from othello_reinforcement_learning_test_tpu_torch.kernels import leaf_step as ls
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import Board, get_engine
from othello_reinforcement_learning_test_tpu_torch.search import mcts

RULE_SETS = [(size, rules) for size in (8, 6, 4) for rules in ("reference", "standard")]


def engine_reference(engine, board_me, board_opp, legal, parent, action, zeros):
    """The leaf step by the engine's rules alone: each game's parent
    position played with ``engine.step``, which finds the pass legality by
    its own flood where the step reads the tree's cached ``legal``, then
    ``engine.observe`` of the child."""
    games = range(len(parent))
    parent_board = Board(me=torch.stack([board_me[b, parent[b]] for b in games]),
                         opp=torch.stack([board_opp[b, parent[b]] for b in games]),
                         move_count=zeros, passed=torch.zeros_like(zeros, dtype=torch.bool))
    child, _ = engine.step(parent_board, action)
    return (child, *engine.observe(child, with_features=True))


def assert_leaf_equal(got, want):
    (child, *rest), (child_w, *rest_w) = got, want
    for a, b in zip((*child, *rest), (*child_w, *rest_w)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("size,rules", RULE_SETS)
def test_plain_equals_the_composition_it_replaced(size, rules):
    eng = get_engine(size, rules)
    case = ls.sample_case(size, rules, 300, 9, seed=size)
    board_me, board_opp, legal, parent, action, zeros = case
    got = ls.leaf_step(eng, *case)
    assert_leaf_equal(got, engine_reference(eng, *case))
    # the cases hold what the search's trees hold: ends of the game (action
    # 0, invalid), parents that can only pass, invalid and valid moves
    rows = torch.arange(len(parent))
    ended = eng.is_terminal(Board(board_me[rows, parent], board_opp[rows, parent], None, None))
    pass_only = legal[rows, parent, eng.pass_action] & ~ended
    valid = got[0].move_count == 1
    assert bool(ended.any()) and bool((action[ended] == 0).all()) and bool(pass_only.any())
    assert bool(valid.any()) and bool((~valid).any()) and bool(got[0].passed.any())
    assert bool(got[2].any())  # children that end the game


def test_the_search_steps_its_leaves_through_the_wrapper():
    """``_step_leaf`` hands the tree's fields and the selection to
    ``leaf_step``; an engine behind a forwarding wrapper (as the benchmark
    passes it) takes the same path."""
    eng = get_engine(6)
    board_me, board_opp, legal, parent, action, zeros = ls.sample_case(6, "reference", 40, 5, seed=3)
    tree = SimpleNamespace(board_me=board_me, board_opp=board_opp, legal=legal)
    sel = SimpleNamespace(parent=parent, action=action)

    class Forwarding:
        def __init__(self):
            self.calls = []

        def __getattr__(self, name):
            return getattr(eng, name)

        def step(self, *a, **k):
            self.calls.append("step")
            return eng.step(*a, **k)

        def observe(self, *a, **k):
            self.calls.append("observe")
            return eng.observe(*a, **k)

    wrapped = Forwarding()
    got = mcts._step_leaf(wrapped, tree, sel, zeros)
    assert wrapped.calls == ["step", "observe"]
    assert_leaf_equal(got, engine_reference(eng, board_me, board_opp, legal, parent, action,
                                            zeros))


def _bad_inputs(bad):
    b_me, b_opp, legal, parent, action, zeros = ls.sample_case(8, "reference", 16, 5, seed=1)
    args = dict(board_me=b_me, board_opp=b_opp, legal=legal, parent=parent, action=action,
                zeros=zeros)
    field, change = {
        "board_dtype": ("board_me", lambda t: t.to(torch.int32)),
        "legal_dtype": ("legal", lambda t: t.to(torch.uint8)),
        "action_dtype": ("action", lambda t: t.to(torch.int32)),
        "zeros_dtype": ("zeros", lambda t: t.to(torch.int64)),
        "legal_shape": ("legal", lambda t: t[:, :, :-1]),
        "parent_shape": ("parent", lambda t: t[:-1]),
        "not_contiguous": ("board_opp", lambda t: t.t().contiguous().t()),
        "legal_not_contiguous": ("legal", lambda t: t.transpose(0, 1).contiguous().transpose(0, 1)),
        "devices": ("parent", lambda t: torch.empty_like(t, device="meta")),
    }[bad]
    args[field] = change(args[field])
    return field, args


@pytest.mark.parametrize("bad", ["board_dtype", "legal_dtype", "action_dtype", "zeros_dtype",
                                 "legal_shape", "parent_shape", "not_contiguous",
                                 "legal_not_contiguous", "devices"])
def test_wrapper_refuses_bad_input_before_a_launch(bad, monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the wrapper reached the library")

    monkeypatch.setattr(build, "load", no_build)
    before = ls.leaf_step.launches
    field, args = _bad_inputs(bad)
    with pytest.raises(ValueError, match=f"^{field} must"):
        ls.leaf_step(get_engine(8), **args)
    assert ls.leaf_step.launches == before


def test_build_names_the_leaf_step_source():
    assert "leaf_step" in build.SOURCES and "leaf_step" in build.UNSHAPED
    assert (build.CSRC_DIR / "leaf_step.cu").is_file()
    # the floods are shared with random_step through one header
    for name in ("leaf_step", "random_step"):
        assert '#include "othello_engine.cuh"' in (build.CSRC_DIR / f"{name}.cu").read_text()
