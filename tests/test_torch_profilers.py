"""The port's profilers (``..._torch/profilers/``) against the JAX package.

At B=8, a 2x16 network (the trainer's initial weights at seed 0), 6
simulations with 3 done. Tolerances, as ``tests/test_torch_mcts.py``:

- the mid-search tree against the JAX script's recipe: integer arrays,
  masks, boards and ``children`` exact; floats (priors, values, value
  sums) atol 1e-6. Both networks run at f32 (flax ``dtype=float32``), the
  bar of ``tests/test_torch_bridge.py`` for one forward, far from the
  PUCT ties of these positions;
- the parts against one simulation of ``mcts.search``, a part's repeated
  calls, and the forward's stem, trunk and heads composed: bit for bit
  (the same operations on the same inputs).
"""

import json
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.models.resnet import OthelloResNet as JaxResNet
from othello_reinforcement_learning_test_tpu.ops.bitboard import Board as JaxBoard
from othello_reinforcement_learning_test_tpu.ops.bitboard import OthelloEngine as JaxEngine
from othello_reinforcement_learning_test_tpu.search import mcts as jm
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_train_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import FusedInference
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from othello_reinforcement_learning_test_tpu_torch.profilers import (
    profile_forward_parts,
    profile_mcts,
    profile_mcts_parts,
    profile_move_glue,
)
from othello_reinforcement_learning_test_tpu_torch.search import mcts as tm
from othello_reinforcement_learning_test_tpu_torch.train.trainer import apply_eval
from torch_stub_net import to_i64

B, SIMS, WARM, BLOCKS, FILTERS = 8, 6, 3, 2, 16
CPU = torch.device("cpu")
TINY = {
    "profile_mcts": ["--batch", "8", "--sims", "6", "--chain", "2", "--repeats", "2",
                     "--blocks", "2", "--filters", "16", "--net-variant", "int8_dx3"],
    "profile_mcts_parts": ["--batch", "8", "--sims", "6", "--warm-sims", "3", "--reps", "2",
                           "--repeats", "2", "--blocks", "2", "--filters", "16"],
    "profile_forward_parts": ["--batch", "8", "--reps", "2", "--repeats", "2", "--blocks",
                              "2", "--filters", "16", "--bgs", "4", "8"],
    "profile_move_glue": ["--batch", "8", "--reps", "2", "--repeats", "2"],
}
MODULES = {m.__name__.rsplit(".", 1)[1]: m for m in (
    profile_mcts, profile_mcts_parts, profile_forward_parts, profile_move_glue)}


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


@pytest.fixture(scope="module")
def variables():
    return init_train_variables(BLOCKS, FILTERS, 0)


@pytest.fixture(scope="module")
def net_f32(variables):
    model = OthelloResNet(BLOCKS, FILTERS)
    model.load_state_dict(from_jax_variables(variables))
    return apply_eval(model.eval(), torch.float32)


def jax_mid_tree(variables):
    """``scripts/profile_mcts_parts.py:54-103`` at this file's sizes, the
    network at f32."""
    engine = JaxEngine(size=8)
    model = JaxResNet(num_blocks=BLOCKS, num_filters=FILTERS, dtype=jnp.float32)
    jvars = jax.tree.map(jnp.asarray, variables)

    def net(x):
        return model.apply(jvars, x, train=False)

    n_slots, A = SIMS + 1, engine.num_actions

    def leaf(tree):
        sel = jm._select(tree, 1.0)
        m_parent = jm._node_mask(sel.parent, n_slots)
        parent_board = JaxBoard(me=jm._take(tree.board_me, m_parent),
                                opp=jm._take(tree.board_opp, m_parent),
                                move_count=jnp.zeros((B,), jnp.int32),
                                passed=jnp.zeros((B,), jnp.bool_))
        ppl = jm._take(tree.legal, m_parent)[:, engine.pass_action]
        child, _ = engine.step(parent_board, sel.action, pass_legal=ppl)
        cl, ct, cw, feats = engine.observe(child, with_features=True)
        log_p, v = net(feats)
        return sel, child, cl, ct, cw, jm.masked_probs(log_p, cl), v[..., 0]

    @jax.jit
    def build_tree():
        boards = engine.initial_state((B,))
        legal0, term0, win0, feats = engine.observe(boards, with_features=True)
        log_p, v0 = net(feats)
        prior0 = jm.masked_probs(log_p, legal0)
        root_value0 = jnp.where(term0, win0.astype(jnp.float32), v0[..., 0])
        tree = jm._init_tree(B, n_slots, A, boards.me, boards.opp, prior0, legal0, term0, win0,
                             root_value0)

        def sim(i, tree):
            sel, child, cl, ct, cw, cp, v = leaf(tree)
            return jm._expand_and_backup(tree, sel, child.me, child.opp, cp, cl, ct, cw, v)

        tree = jax.lax.fori_loop(0, WARM, sim, tree)
        return (tree, *leaf(tree))

    return jax.tree.map(np.asarray, build_tree())


def assert_tree_equal(t, j, slots=None):
    """A port tree against a JAX tree (integers exact, floats atol 1e-6) or
    against a port tree (bit for bit), over the first ``slots`` slots."""
    s = slice(None) if slots is None else slice(0, slots)
    for f in fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a if f.name == "num_nodes" else a[:, s],
                               b if f.name == "num_nodes" else b[:, s]), f.name
            continue
        a = a.numpy()
        if f.name == "num_nodes":
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
            continue
        b = to_i64(b) if f.name.startswith("board_") else np.asarray(b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a[:, s], b[:, s], atol=1e-6, rtol=0, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a[:, s], b[:, s], err_msg=f.name)


def test_mid_tree_matches_jax_recipe(variables, net_f32):
    mid = profile_mcts_parts.build_mid_tree(get_engine(8), net_f32, B, SIMS, WARM, CPU)
    jtree, jsel, jchild, jcl, jct, jcw, jcp, jv = jax_mid_tree(variables)
    assert_tree_equal(mid.tree, jtree)
    assert int(mid.tree.num_nodes.min()) == WARM + 1  # every walk expanded here
    for name in ("parent", "action", "path", "path_action", "path_len", "is_term_leaf"):
        np.testing.assert_array_equal(getattr(mid.sel, name).numpy(), getattr(jsel, name),
                                      err_msg=name)
    np.testing.assert_array_equal(mid.child.me.numpy(), to_i64(jchild.me))
    np.testing.assert_array_equal(mid.child.opp.numpy(), to_i64(jchild.opp))
    np.testing.assert_array_equal(mid.legal.numpy(), jcl)
    np.testing.assert_array_equal(mid.terminal.numpy(), jct)
    np.testing.assert_array_equal(mid.winner.numpy(), jcw)
    np.testing.assert_allclose(mid.prior.numpy(), jcp, atol=1e-6, rtol=0)
    np.testing.assert_allclose(mid.value.numpy(), jv, atol=1e-6, rtol=0)


@pytest.mark.parametrize("variant", ["xla", "int8_dx3"])
def test_parts_in_order_are_one_simulation_of_search(variant):
    engine = get_engine(8)
    net = profile_mcts_parts.make_net(BLOCKS, FILTERS, variant, CPU)
    mid = profile_mcts_parts.build_mid_tree(engine, net, B, SIMS, WARM, CPU)
    parts = profile_mcts_parts.parts(engine, net, mid)
    sel = parts["select walk"]()
    child, legal, term, win, feats = parts["parent gather+step+obs"]()
    log_p, v = parts["forward"]()
    prior = parts["masked_probs"]()
    for a, b in zip(sel, mid.sel):
        assert torch.equal(a, b)
    for a, b in ((child.me, mid.child.me), (legal, mid.legal), (feats, mid.feats),
                 (log_p, mid.log_p), (prior, mid.prior), (v[:, 0], mid.value)):
        assert torch.equal(a, b)
    parts["expand+backup"]()
    boards = engine.initial_state((B,))
    _, tree = tm.search(engine, net, boards, WARM + 1, return_tree=True)
    assert_tree_equal(mid.tree, tree, slots=WARM + 2)
    # the tree's remaining slots are untouched
    assert bool((mid.tree.children[:, WARM + 2:] == tm.NO_CHILD).all())
    assert int(mid.tree.visit[:, WARM + 2:].abs().sum()) == 0


def tree_copy(tree):
    return {f.name: getattr(tree, f.name).clone() for f in fields(tree)}


def test_each_part_leaves_the_state_as_it_found_it(net_f32):
    engine = get_engine(8)
    mid = profile_mcts_parts.build_mid_tree(engine, net_f32, B, SIMS, WARM, CPU)
    restore = profile_mcts_parts.snapshot(mid.tree)
    before = tree_copy(mid.tree)
    inputs = [x.clone() for x in (mid.feats, mid.log_p, mid.prior, mid.value, *mid.sel)]
    named = dict(profile_mcts_parts.parts(engine, net_f32, mid))
    named["whole simulation"] = lambda: tm._simulate(engine, net_f32, mid.tree, mid.zeros, 1.0)
    for name, part in named.items():
        writes = name in profile_mcts_parts.WRITES_TREE
        outs = []
        for _ in range(2):
            if writes:
                restore()
            outs.append(part())
        if writes:
            assert any(not torch.equal(before[k], getattr(mid.tree, k)) for k in before), name
            restore()
        else:
            for a, b in zip(outs[0], outs[1]):
                assert all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) \
                    else torch.equal(a, b), name
        assert all(torch.equal(before[k], getattr(mid.tree, k)) for k in before), name
        assert all(torch.equal(x, y) for x, y in zip(
            inputs, (mid.feats, mid.log_p, mid.prior, mid.value, *mid.sel))), name


def test_glue_parts_repeat_the_same_work():
    parts = profile_move_glue.glue_parts(get_engine(8), B, CPU)
    for name, (part, restore) in parts.items():
        outs = []
        for _ in range(2):
            if restore:
                restore()
            outs.append([torch.as_tensor(x).clone()
                         for x in torch.utils._pytree.tree_leaves(part())])
        assert outs[0] and all(torch.equal(a, b) for a, b in zip(*outs)), name


@pytest.mark.parametrize("variant", ["int8_dx3", "int8_dxcat", "matmul9"])
def test_stem_trunk_heads_compose_to_the_forward(variant, variables):
    model = OthelloResNet(BLOCKS, FILTERS)
    model.load_state_dict(from_jax_variables(variables))
    fused = FusedInference(model.eval(), variant)
    # the trunk as profile_forward_parts builds it for one block size
    trunk = FusedInference(model, variant, block_games=fused.block_games).trunk
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((B, 8, 8, 3)).astype(np.float32))
    lp, v = fused.heads(trunk(fused.stem(x)))
    lp_ref, v_ref = fused(x)
    assert torch.equal(lp, lp_ref) and torch.equal(v, v_ref)


@pytest.mark.parametrize("lost, pads, complete", [
    (0, [64, 64], True),
    (2, [64, 256, 1024, 1024], True),
    (7, [64, 256, 1024, 1024, 1024, 1024, 1024, 1024], True),
    (8, [64, 256, 1024, 1024, 1024, 1024, 1024, 1024], False),
])
@pytest.mark.parametrize("loss", ["one side", "every operation"])
def test_profiled_sessions_retry_until_complete(lost, pads, complete, loss, monkeypatch):
    """The card's profiled passes with their device records faked: the
    first ``lost`` sessions keep no marker on one side, or markers on both
    sides but no operation of the part, and every session after an
    incomplete one has longer marker runs, until two passes are complete or
    PROFILE_SESSIONS ran; the figures come from a complete pass."""
    from types import SimpleNamespace

    from othello_reinforcement_learning_test_tpu_torch.profilers import common

    def op(us):
        return SimpleNamespace(name="kernel", time_range=SimpleNamespace(elapsed_us=lambda: us))

    calls = []

    def session(part, pad):
        calls.append(pad)
        if len(calls) <= lost:  # an incomplete pass keeps fewer operations
            return (1.0, [op(1.0)], 0, pad) if loss == "one side" else (1.0, [], pad, pad)
        return 2.0, [op(3.0), op(4.0)], pad - 27, pad

    monkeypatch.setattr(common, "_session", session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    prof = common._profiled(lambda: None, lambda: None)
    assert calls == pads and prof["tries"] == len(pads)
    assert prof["profile_complete"] is complete
    assert [p["complete"] for p in prof["passes"]] == [i >= lost for i in range(len(pads))]
    if complete:
        assert prof["launches"] == 2 and prof["device_busy_ms"] == pytest.approx(7e-3)
        assert prof["top"] == [["kernel", pytest.approx(7e-3), 2]]
    else:
        assert prof["launches"] == (1 if loss == "one side" else 0)


def test_profiled_part_without_device_work_is_complete_with_no_operations(monkeypatch):
    """The null row's passes: markers on both sides and nothing between
    them is complete for a part that runs nothing on the device."""
    from othello_reinforcement_learning_test_tpu_torch.profilers import common

    monkeypatch.setattr(common, "_session", lambda part, pad: (0.5, [], 2 * pad, 2 * pad))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    prof = common._profiled(lambda: None, lambda: None, device_work=False)
    assert prof["profile_complete"] and prof["tries"] == 2
    assert prof["launches"] == 0 and prof["device_busy_ms"] == 0 and prof["top"] == []


@pytest.mark.parametrize("name", sorted(TINY))
def test_profiler_main_on_the_cpu(name, capsys):
    assert MODULES[name].main(["--device", "cpu", *TINY[name]]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["profiler"] == name and out["device"] == "cpu"
    rows = out["rows"]
    assert rows[0]["name"].startswith("null")
    for row in rows:
        assert any(ln.startswith(row["name"]) for ln in lines[:-1]), row["name"]
        assert np.isfinite(row["wall_ms"]["best"]) and row["wall_ms"]["best"] >= 0
        assert row["device_busy_ms"] is None and row["syncs"] is None
    if name == "profile_mcts_parts":
        assert [r["name"] for r in rows[1:]] == [
            "select walk", "parent gather+step+obs", "forward", "masked_probs",
            "expand+backup", "whole simulation"]
    if name == "profile_move_glue":
        lengths = out["game_lengths"]
        assert 0 < lengths["mean"] <= lengths["max"] and lengths["tail_factor"] >= 1


@pytest.mark.parametrize("name", sorted(TINY))
def test_profiler_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MODULES[name].main(TINY[name])


def test_profilers_import_without_jax():
    """In a fresh interpreter, so that no module of the port comes from an
    earlier import: every profiler and what it imports load with jax and
    the JAX package blocked."""
    pkg = "othello_reinforcement_learning_test_tpu_torch.profilers"
    code = "\n".join(
        ["import importlib, sys",
         *[f"sys.modules[{m!r}] = None"
           for m in ("jax", "jaxlib", "othello_reinforcement_learning_test_tpu")],
         *[f"assert importlib.import_module('{pkg}.{name}').main" for name in MODULES],
         "print('imported', len(sys.modules))"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("imported"), out.stderr[-2000:]
