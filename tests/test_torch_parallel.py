"""The port's data parallelism against the JAX package's ``dp`` mesh.

Two gloo ranks over ``tcp://127.0.0.1`` (``torch_mp_worker.py``, one torch
thread each, no JAX) against JAX on ``conftest.py``'s virtual CPU devices
(``make_mesh(2)``) and against the port in one process. One process pair
serves several checks and ends in a fail-fast run; the two pairs and the
weak-scaling benchmark start with the module and run, each under a
deadline, while the JAX references compile here. Tolerances:

- the 2-rank SGD step (f64, 2 blocks x 8 filters, batch 32): the two
  ranks bit-equal; parameters and BatchNorm statistics rtol 1e-9 against
  the port's single-process full-batch step (only the split of the
  BatchNorm moments and of the gradient sums differs), the losses rtol
  1e-6 (the policy head's log-probabilities are float32, as flax's, so the
  logged loss is a float32 mean, here of two half-batch means); against JAX
  ``train_steps(..., mesh=make_mesh(2))`` at f64, the bar of
  ``test_torch_train.py::test_train_step_matches_flax`` (loss rtol 1e-5,
  parameters and statistics rtol 1e-4, atol 1e-6; JAX draws another
  permutation of the same 32 entries);
- self-play with the stub network, the sharded arena, ``cond_interval``,
  the trainer's iterations, gating and resume: exact (pi against JAX atol
  1e-6, as ``test_torch_selfplay.py``: its normalising sum is taken in
  another order).
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.evaluation import arena as jarena
from othello_reinforcement_learning_test_tpu.evaluation import players as jplayers
from othello_reinforcement_learning_test_tpu.models.resnet import OthelloResNet as JaxResNet
from othello_reinforcement_learning_test_tpu.ops import bitboard as jbb
from othello_reinforcement_learning_test_tpu.parallel import make_mesh
from othello_reinforcement_learning_test_tpu.train import buffer as jbuf
from othello_reinforcement_learning_test_tpu.train import self_play as jsp
from othello_reinforcement_learning_test_tpu.train import trainer as jtr
from othello_reinforcement_learning_test_tpu_torch.models.convert import to_jax_variables
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from othello_reinforcement_learning_test_tpu_torch.parallel import mesh
from othello_reinforcement_learning_test_tpu_torch.search import mcts
from othello_reinforcement_learning_test_tpu_torch.train import self_play as tsp
from torch_stub_net import jax_stub, stub_weights, to_i64, to_pair
import torch_mp_worker as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here, as in the workers: the games are chains of
    tiny ops, which a thread pool turns into spin-waits on shared cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


class Launched:
    """Processes started now and waited for on first use: ``wait()`` gives
    their ``(return codes, outputs)``; past ``timeout`` seconds from the
    start they are killed and the test fails."""

    def __init__(self, argvs, timeout):
        self.t0, self.timeout = time.time(), timeout
        self.procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True, env=ENV, cwd=REPO) for a in argvs]
        self.done = None

    def wait(self):
        if self.done is None:
            outs = []
            try:
                for p in self.procs:
                    left = self.timeout - (time.time() - self.t0)
                    outs.append(p.communicate(timeout=max(left, 1))[0])
            except subprocess.TimeoutExpired:
                pytest.fail(f"still running after {self.timeout} s: {self.procs[0].args}")
            finally:
                self.kill()
            self.done = [p.returncode for p in self.procs], outs
        return self.done

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def pair(mode, outdir, extra=None, timeout=150):
    port = free_port()
    return Launched([[sys.executable, WORKER, mode, str(rank), "2", str(port), str(outdir)]
                     + ([str(extra)] if extra is not None else []) for rank in range(2)],
                    timeout)


BENCH = ["--processes", "1", "2", "--games-per-process", "4", "--simulations", "2",
         "--blocks", "1", "--filters", "8", "--repeats", "1", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """The core pair, the train pair and the weak-scaling benchmark, started
    together before the module's first test."""
    dirs = {m: tmp_path_factory.mktemp(m) for m in ("core", "train")}
    runs = {"core": pair("core", dirs["core"]),
            "train": pair("train", dirs["train"], extra=free_port()),
            "bench": Launched([[sys.executable, "-m",
                                "othello_reinforcement_learning_test_tpu_torch.benchmark_multihost",
                                *BENCH]], 150)}
    yield runs, dirs
    for r in runs.values():
        r.kill()


def finished(launched, mode):
    """The pair's result files, once both ranks ended in their fail-fast run
    (exit codes checked by ``test_failfast``)."""
    runs, dirs = launched
    rcs, outs = runs[mode].wait()
    d = dirs[mode]
    if not all((d / f"result_{r}.json").is_file() for r in range(2)):
        pytest.fail(f"{mode} pair wrote no results:\n" + outs[0][-3000:] + outs[1][-3000:])
    return d, [json.loads((d / f"result_{r}.json").read_text()) for r in range(2)]


@pytest.fixture
def core(launched):
    return finished(launched, "core")


@pytest.fixture
def trained(launched):
    return finished(launched, "train")[1]


# -- the SGD step -------------------------------------------------------------------


def jax_mesh_step(sd, me, opp, pi, value):
    """JAX ``train_steps`` over ``make_mesh(2)`` at f64 on a buffer that holds
    exactly the batch: new parameters, statistics and the loss."""
    with jax.enable_x64(True):
        model = JaxResNet(num_blocks=2, num_filters=8, dtype=jnp.float64)
        v = to_jax_variables(sd)
        f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
        params, stats = jax.tree.map(f64, v["params"]), jax.tree.map(f64, v["batch_stats"])
        tx = jtr.make_optimizer(W.SGD_CFG)
        state = jtr.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                               step=jnp.int32(0), iteration=jnp.int32(0))
        n = me.shape[0]
        traj = jsp.Trajectory(
            me=jnp.asarray(to_pair(me.numpy()))[:, None], opp=jnp.asarray(to_pair(opp.numpy()))[:, None],
            pi=jnp.asarray(pi.numpy())[:, None], value=jnp.asarray(value.numpy())[:, None],
            mask=jnp.ones((n, 1), bool), final_me_count=jnp.zeros(n, jnp.int32),
            final_opp_count=jnp.zeros(n, jnp.int32), winner_black=jnp.zeros(n, jnp.int32),
            num_moves=jnp.ones(n, jnp.int32))
        buf = jbuf.add(jbuf.create(n, 65), traj)
        new, metrics = jtr.train_steps(model, jbb.get_engine(8), tx, state, buf,
                                       jax.random.PRNGKey(0), batch_size=n, num_steps=1,
                                       mesh=make_mesh(2))
        new, loss = jax.device_get((new, metrics["loss"][0]))
        return new.params, new.batch_stats, float(loss)


def test_sgd_step_two_ranks_equal_single_process_and_jax_mesh(launched):
    inputs = W.sgd_inputs()
    params_j, stats_j, loss_j = jax_mesh_step(*inputs)
    want, want_losses = W.sgd_step(*inputs)  # this process: no process group
    d, res = finished(launched, "core")
    ranks = [torch.load(d / f"sgd_{r}.pt", weights_only=True) for r in range(2)]
    assert all(torch.equal(ranks[0][k], ranks[1][k]) for k in want)
    assert res[0]["sgd_losses"] == res[1]["sgd_losses"]
    for k, t in want.items():
        if t.is_floating_point():
            np.testing.assert_allclose(ranks[0][k].numpy(), t.numpy(), rtol=1e-9, atol=0,
                                       err_msg=k)
        else:
            assert torch.equal(ranks[0][k], t), k
    for k, v in want_losses.items():
        np.testing.assert_allclose(res[0]["sgd_losses"][k], v, rtol=1e-6)
    moved = inputs[0]["res_blocks.0.bn1.running_mean"]
    assert not torch.allclose(ranks[0]["res_blocks.0.bn1.running_mean"].float(), moved)

    got = to_jax_variables(ranks[0])
    np.testing.assert_allclose(res[0]["sgd_losses"]["loss"], loss_j, rtol=1e-5)
    for tree, ref in ((got["params"], params_j), (got["batch_stats"], stats_j)):
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                     jax.tree_util.tree_leaves_with_path(ref)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))


# -- self-play ----------------------------------------------------------------------


def trajectories(d):
    return [torch.load(d / f"selfplay_{r}.pt", weights_only=False) for r in range(2)]


def assert_equal_trajectories(a, b):
    for x, y, name in zip(a, b, tsp.Trajectory._fields):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), name


def test_global_self_play_matches_jax_mesh_and_unsharded(launched):
    jt = jsp.play_games(jbb.get_engine(8), jax_stub,
                        jax.tree.map(jnp.asarray, stub_weights(8, seed=8)),
                        jax.random.PRNGKey(0), mesh=make_mesh(2), temperature_threshold=0,
                        add_noise=False, **W.SELFPLAY)
    jt = jax.tree.map(np.asarray, jt)
    d, _ = finished(launched, "core")
    got = trajectories(d)
    assert_equal_trajectories(got[0]["plain"], got[1]["plain"])
    assert_equal_trajectories(got[0]["plain"], W.self_play())
    tt = tsp.Trajectory(*got[0]["plain"])
    np.testing.assert_array_equal(tt.me.numpy(), to_i64(jt.me))
    np.testing.assert_array_equal(tt.opp.numpy(), to_i64(jt.opp))
    np.testing.assert_allclose(tt.pi.numpy(), jt.pi, atol=1e-6, rtol=0)
    for name in ("value", "mask", "final_me_count", "final_opp_count", "winner_black",
                 "num_moves"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), getattr(jt, name), name)


def test_global_self_play_with_noise_and_sampling_matches_unsharded(core):
    d, _ = core
    got = trajectories(d)
    want = W.self_play(noise=True)
    assert_equal_trajectories(got[0]["noise"], want)
    assert_equal_trajectories(got[1]["noise"], want)
    # the noise and the sampled moves make the games differ
    assert len({int(w) for w in want.me[:, 6]}) > 1
    local = [torch.load(d / f"local_{r}.pt", weights_only=False)["noise"] for r in range(2)]
    assert [len(t[0]) for t in local] == [4, 4]


@pytest.mark.parametrize("k", [2, 4])
def test_cond_interval_bit_identical(core, k):
    """Trajectories across 2 ranks and in one process, and one search's
    result and tree, with liveness tested every k steps equal k = 1."""
    d, _ = core
    got = trajectories(d)
    for r in range(2):
        assert_equal_trajectories(got[r][f"noise_k{k}"], got[r]["noise"])
    assert_equal_trajectories(W.self_play(noise=True, cond_interval=k), W.self_play(noise=True))
    eng = get_engine(8)
    boards = W.self_play(noise=True)
    from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import Board

    b = Board(boards.me[:, 8], boards.opp[:, 8], torch.full((8,), 8, dtype=torch.int32),
              torch.zeros(8, dtype=torch.bool))
    out = []
    for ci in (1, k):
        gen = torch.Generator().manual_seed(2)
        res, tree = mcts.search(eng, W.stub_net(), b, 6, add_noise=True, generator=gen,
                                return_tree=True, cond_interval=ci)
        out.append((res, tree))
    for x, y in zip(out[0][0], out[1][0]):
        assert torch.equal(x, y)
    for f in ("visit", "value_sum", "children", "child_visit", "num_nodes"):
        assert torch.equal(getattr(out[0][1], f), getattr(out[1][1], f)), f


@pytest.mark.parametrize("processes,platform", [(1, "cpu"), (2, "cpu"), (2, "gpu"),
                                                (4, "gpu"), (2, "tpu")])
def test_auto_cond_interval_equals_jax(processes, platform):
    assert (tsp.auto_cond_interval(processes, platform)
            == jsp.auto_cond_interval(processes, platform))


# -- the arena ----------------------------------------------------------------------


def test_sharded_arena_matches_unsharded_and_jax_mesh(launched):
    """Every rank's summary of the three sharded matches equals the unsharded
    matches'; Greedy against Greedy equals the JAX mesh's match too (JAX's
    random streams differ from torch's, and its MCTS match would compile
    for seconds more; ``test_torch_eval.py`` holds the stub MCTS player to
    JAX's)."""
    jeng = jbb.get_engine(8)
    s = jarena.Arena(jeng, mesh=make_mesh(2)).play_matches(
        jplayers.GreedyPlayer(jeng), jplayers.GreedyPlayer(jeng), W.ARENA_GAMES,
        jax.random.PRNGKey(0))
    want = [s.wins, s.losses, s.draws, [r.winner for r in s.results],
            [r.player1_score for r in s.results], [r.player2_score for r in s.results],
            [r.num_moves for r in s.results]]
    _, res = finished(launched, "core")
    assert res[0]["arena"] == res[1]["arena"]
    assert res[0]["arena"] == W.arena_matches()
    assert res[0]["arena"][2] == want


def test_collectives_on_uneven_shares(core):
    _, res = core
    for r in res:
        assert r["gathered"] == [[0, 1, 2, 10, 11], [[False] * 2] * 3 + [[True] * 2] * 2]
        assert r["broadcast"] == [2.0] * 3
    assert res[0]["seed"] != res[1]["seed"]
    assert [res[0]["seed"], res[1]["seed"]] == [mesh.fold_in_process(7, r) for r in range(2)]
    assert [res[0]["local_slice"], res[1]["local_slice"]] == [[0, 2], [2, 5]]
    assert mesh.local_slice(5) == slice(0, 5)  # no process group: the whole batch
    assert len({mesh.fold_in_process(7, r) for r in range(64)}) == 64


# -- the trainer --------------------------------------------------------------------


@pytest.mark.parametrize("run", ["local", "global", "local_prio"])
def test_trainer_iteration_identical_on_both_ranks(trained, run):
    a, b = (r[run] for r in trained)
    assert {k: v for k, v in a.items() if k != "seeds"} == {
        k: v for k, v in b.items() if k != "seeds"}
    assert a["filled"] > 0 and a["iteration"] == 1 and a["step"] == 2
    if run.startswith("local"):
        assert a["seeds"] != b["seeds"]  # fold_in_process
    else:
        assert a["seeds"] == b["seeds"]


def test_gating_identical_decision(trained):
    a, b = (r["gate"] for r in trained)
    assert a == b
    assert a["games"] == 8 and sum(a["wld"]) == 8


def test_resume_bit_identical_and_cli_coordinator(trained):
    for r in trained:
        assert r["full"] == trained[0]["full"] and r["part2"] == trained[0]["part2"]
        assert r["part1"]["iteration"] == 2 and r["full"]["iteration"] == 4
        assert r["part2"] == r["full"]
        log = r["cli_log"]
        assert f"distributed: process {r['rank']}/2 up, 2 global devices" in log
        assert "at iteration 2" in log and "iter 4/4" in log and "iter 1/" not in log


@pytest.mark.parametrize("mode,which", [("train", "both"), ("core", "rank0")])
def test_failfast(launched, mode, which):
    """Each pair ends in a trainer with a fault injected in iteration 2 (on
    both ranks after ``train``, on rank 0 alone after ``core``): it re-raises
    without healing, the faulting ranks exit 17 and a surviving peer fails
    in its next collective, all before the pair's deadline."""
    finished(launched, mode)
    rcs, outs = launched[0][mode].wait()
    assert rcs[0] == 17 and rcs[1] != 0, outs[0][-3000:] + outs[1][-3000:]
    if which == "both":
        assert rcs[1] == 17, outs[1][-3000:]
    for out in outs:
        tail = out[out.index("fail-fast run"):]
        assert "re-raising" in tail, tail[-3000:]
        assert "self-heal:" not in tail and "self-healing attempt" not in tail, tail[-3000:]


# -- the weak-scaling benchmark -------------------------------------------------------

# the root benchmark_multihost.py's keys: its n{N}.json lines (with the
# median's fields) and the summary line
ROW_KEYS = {"processes", "design", "games", "games_per_s", "env_steps_per_s", "wall_s",
            "assembly_ms_per_iter", "assembly_bytes_per_process", "repeats", "games_per_s_all"}
SUMMARY_KEYS = {"metric", "value", "unit", "per_n", "note"}


def test_benchmark_multihost_cpu(launched):
    (rc,), (out,) = launched[0]["bench"].wait()
    assert rc == 0, out[-3000:]
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert [set(x) for x in lines] == [ROW_KEYS, ROW_KEYS, SUMMARY_KEYS]
    assert [x["processes"] for x in lines[:2]] == [1, 2] and lines[1]["games"] == 8
    assert lines[2]["metric"] == "multihost_weak_scaling_efficiency" and lines[2]["value"] > 0
