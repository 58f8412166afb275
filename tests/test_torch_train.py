"""PyTorch port of the training iteration against the JAX package.

Inputs are made from a numpy seed and fed to both frameworks. Tolerances,
each with its reason:

- ``symmetries`` and the ``to_jax_variables`` round trip: exact (the same
  index permutations);
- the learning-rate schedule: rtol 1e-6 (optax computes it in float32);
- three SGD steps with momentum and weight decay against optax at float32:
  rtol 1e-6, atol 1e-9 (the same operations; optax multiplies by -lr where
  torch adds with alpha -lr);
- loss, gradients and one SGD step against flax: loss rtol 1e-5; every
  gradient leaf, updated parameter and BatchNorm statistic rtol 1e-4, atol
  1e-6. JAX's own float32 gradients of the trunk on the CPU differ from its
  float64 ones by up to 4e-4 (relative L2 norm of a leaf), so the reference
  side of this comparison runs at float64 (``jax.enable_x64``); the port is
  held to it at float64 and at float32, where its gradients agree with
  float64 to about 1e-6;
- the same at bf16 compute, loose: loss rtol 2e-3 and BatchNorm statistics
  rtol 1e-2 against flax at bf16; each gradient leaf within 0.35 of the
  float64 gradient in relative L2 norm, and each updated parameter within
  0.5 * lr * max|grad| of the float64 step. bf16 keeps 8 bits and the
  BatchNorm backward amplifies its rounding; the port rounds to bf16 after
  every op, as the program is written, where XLA keeps fused elementwise
  chains in f32, so the port's bf16 gradients sit further from float64
  than JAX's and are not compared with JAX's leaf by leaf;
- the whole slice, one ``_train_iteration``, f32: trajectories and buffer
  exact (pi atol 1e-6, its normalising sum is taken in another order);
  losses rtol 1e-5; final parameters and statistics rtol 1e-4, atol 1e-6.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from othello_reinforcement_learning_test_tpu.models.resnet import OthelloResNet as JaxResNet
from othello_reinforcement_learning_test_tpu.ops import bitboard as jbb
from othello_reinforcement_learning_test_tpu.train import trainer as jtr
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
    init_train_variables,
    to_jax_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import FusedInference
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from othello_reinforcement_learning_test_tpu_torch.train import checkpoint as ckpt
from othello_reinforcement_learning_test_tpu_torch.train import trainer as ttr
from othello_reinforcement_learning_test_tpu_torch.utils.metrics import MetricsWriter
from torch_stub_net import to_i64

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
    """Both packages' MetricsWriter write TensorBoard files only when it
    imports; here that would pull in tensorflow (tens of seconds). The JSONL
    stream, the contract, is written either way."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def leaves_with_paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_close(port, ref, rtol, atol, what=""):
    a, b = leaves_with_paths(port), leaves_with_paths(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], np.asarray(b[k], a[k].dtype), rtol=rtol, atol=atol,
                                   err_msg=what + k)


# -- engine symmetries and weight conversion ----------------------------------


@pytest.mark.parametrize("size", [6, 8])
def test_symmetries_match_jax(size):
    rng = np.random.default_rng(size)
    feats = rng.random((3, size, size, 3)).astype(np.float32)
    pi = rng.random((3, size * size + 1)).astype(np.float32)
    f8, p8 = get_engine(size).symmetries(torch.from_numpy(feats), torch.from_numpy(pi))
    jf8, jp8 = jbb.get_engine(size).symmetries(jnp.asarray(feats), jnp.asarray(pi))
    assert f8.shape == (3, 8, size, size, 3) and p8.shape == (3, 8, size * size + 1)
    np.testing.assert_array_equal(f8.numpy(), np.asarray(jf8))
    np.testing.assert_array_equal(p8.numpy(), np.asarray(jp8))
    assert torch.equal(p8[..., -1], torch.from_numpy(pi[:, None, -1]).expand(3, 8))


@pytest.mark.parametrize("num_blocks,num_filters,size", [(2, 16, 8), (1, 8, 6)])
def test_to_jax_variables_round_trip(num_blocks, num_filters, size):
    v = init_numpy_variables(num_blocks, num_filters, seed=1, board_size=size)
    back = to_jax_variables(from_jax_variables(v))
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    m = OthelloResNet(num_blocks, num_filters, size)
    sd = from_jax_variables(back)
    m.load_state_dict(sd)
    for k, t in from_jax_variables(to_jax_variables(m.state_dict())).items():
        assert torch.equal(t, sd[k]), k


def test_init_train_variables_is_flax_shaped():
    v = init_train_variables(2, 16, seed=0)
    ref = jax.eval_shape(JaxResNet(num_blocks=2, num_filters=16).init, jax.random.PRNGKey(0),
                         jnp.zeros((1, 8, 8, 3)))
    assert jax.tree.structure(v) == jax.tree.structure(ref)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(ref)))
    k = v["params"]["ResBlock_0"]["Conv_0"]["kernel"]
    assert abs(k.std() * np.sqrt(9 * 16) - 1) < 0.1 and np.abs(k).max() <= 2 / 0.8796 / 12 + 1e-6


# -- schedule and optimizer ---------------------------------------------------


@pytest.mark.parametrize("mode", ["step", "constant"])
def test_lr_schedule_matches_optax(mode):
    cfg = {"training": {"lr": 0.006, "lr_schedule": mode, "lr_step_size": 350,
                        "lr_gamma": 0.2, "train_epochs_per_iter": 24}}
    boundary = 350 * 24
    ours, ref = ttr.make_lr_schedule(cfg), jtr.make_lr_schedule(cfg)
    for k in (0, boundary - 1, boundary, 2 * boundary):
        np.testing.assert_allclose(ours(k), float(ref(k)), rtol=1e-6, err_msg=str(k))
    if mode == "step":
        assert ours(boundary - 1) == 0.006 and ours(boundary) == pytest.approx(0.006 * 0.2)


def test_sgd_steps_match_optax():
    """Three steps from the same parameters with momentum and weight decay,
    crossing an LR boundary (lr_step_size 1 x 2 epochs: steps 0-1 at lr,
    step 2 at lr * gamma)."""
    cfg = {"training": {"lr": 0.1, "lr_step_size": 1, "lr_gamma": 0.5,
                        "train_epochs_per_iter": 2, "momentum": 0.9, "weight_decay": 1e-2}}
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx = jtr.make_optimizer(cfg)
    params = jax.tree.map(jnp.asarray, p0)
    opt = tx.init(params)
    for g in grads:
        upd, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, params)
        params = optax.apply_updates(params, upd)
    model = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                    for k, v in p0.items()})
    state = ttr.TrainState(model, ttr.make_optimizer(model, cfg))
    sched = ttr.make_lr_schedule(cfg)
    for g in grads:
        for k, p in model.items():
            p.grad = torch.from_numpy(g[k].copy())
        ttr.optimizer_step(state, sched)
    assert state.step == 3
    for k, p in model.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)


# -- loss, gradients and one SGD step -------------------------------------------

STEP_CFG = {"training": {"lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}}


def step_batch(batch=32, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 2, (batch, 8, 8, 3)).astype(np.float32)
    pi = rng.random((batch, 65)).astype(np.float32)
    pi /= pi.sum(-1, keepdims=True)
    tv = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (batch, 1))
    return feats, pi, tv


def jax_step(v, batch, dtype):
    """flax loss, gradients, one optax step and the new BatchNorm statistics
    (numpy trees)."""
    with jax.enable_x64(dtype == jnp.float64):
        model = JaxResNet(num_blocks=2, num_filters=16, dtype=dtype)
        cast = (lambda a: jnp.asarray(a, dtype)) if dtype == jnp.float64 else jnp.asarray
        params, stats = jax.tree.map(cast, v["params"]), jax.tree.map(cast, v["batch_stats"])
        tx = jtr.make_optimizer(STEP_CFG)

        @jax.jit
        def step(params, feats, pi, tv):
            (total, (_, _, new_stats)), grads = jax.value_and_grad(
                lambda p: jtr.loss_fn(model, p, stats, feats, pi, tv), has_aux=True)(params)
            upd, _ = tx.update(grads, tx.init(params), params)
            return total, grads, optax.apply_updates(params, upd), new_stats

        total, grads, new_params, new_stats = jax.device_get(step(params, *map(cast, batch)))
        return float(total), grads, new_params, new_stats


def port_step(v, batch, dtype):
    m = OthelloResNet(2, 16)
    m.load_state_dict(from_jax_variables(v))
    param_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    m.to(param_dtype)  # float32 parameters under bf16 compute, as flax
    state = ttr.TrainState(m, ttr.make_optimizer(m, STEP_CFG))
    feats, pi, tv = (torch.from_numpy(a).to(param_dtype) for a in batch)
    metrics = ttr.train_on_batch(state, feats, pi, tv, ttr.make_lr_schedule(STEP_CFG), dtype)
    sd = {k: t.clone() for k, t in m.state_dict().items()}
    sd.update({name: p.grad for name, p in m.named_parameters()})
    after = to_jax_variables(m.state_dict())
    return (float(metrics["loss"]), to_jax_variables(sd)["params"], after["params"],
            after["batch_stats"])


@pytest.mark.parametrize("port_dtype", [torch.float64, torch.float32])
def test_train_step_matches_flax(port_dtype):
    """Loss, every gradient leaf, the updated parameters and the BatchNorm
    running statistics (flax momentum 0.99, biased batch variance) against
    flax at float64."""
    v = init_numpy_variables(2, 16, seed=4)
    batch = step_batch()
    loss_j, grads_j, params_j, stats_j = jax_step(v, batch, jnp.float64)
    loss_t, grads_t, params_t, stats_t = port_step(v, batch, port_dtype)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    assert_trees_close(grads_t, grads_j, 1e-4, 1e-6, "grad ")
    assert_trees_close(params_t, params_j, 1e-4, 1e-6, "param ")
    assert_trees_close(stats_t, stats_j, 1e-4, 1e-6, "stat ")
    # the statistics moved, with flax's weights: 0.99 old + 0.01 batch
    mean0 = v["batch_stats"]["ResBlock_1"]["BatchNorm_1"]["mean"]
    assert not np.allclose(stats_t["ResBlock_1"]["BatchNorm_1"]["mean"], mean0, atol=1e-4)


def test_train_step_matches_flax_bf16():
    v = init_numpy_variables(2, 16, seed=4)
    batch = step_batch()
    _, grads_64, params_64, _ = jax_step(v, batch, jnp.float64)
    loss_j, _, _, stats_j = jax_step(v, batch, jnp.bfloat16)
    loss_t, grads_t, params_t, stats_t = port_step(v, batch, torch.bfloat16)
    np.testing.assert_allclose(loss_t, loss_j, rtol=2e-3)
    assert_trees_close(stats_t, stats_j, 1e-2, 1e-6, "stat ")
    g64, gt = leaves_with_paths(grads_64), leaves_with_paths(grads_t)
    p64, pt = leaves_with_paths(params_64), leaves_with_paths(params_t)
    lr = STEP_CFG["training"]["lr"]
    for k in g64:
        ref = g64[k]
        assert np.linalg.norm(gt[k] - ref) <= 0.35 * np.linalg.norm(ref), k
        assert np.abs(pt[k] - p64[k]).max() <= 0.5 * lr * np.abs(ref).max() + 1e-6, k


# -- the whole slice: one training iteration, port vs JAX ------------------------


def slice_config(tmp_path, name, **training):
    t = {"batch_size": 24, "lr": 0.05, "num_iterations": 1, "self_play_episodes_per_iter": 4,
         "train_epochs_per_iter": 3, "checkpoint_interval": 100, "replay_buffer_size": 24,
         "augment_symmetries": False}
    t.update(training)
    return {"game": {"size": 4, "rules": "reference"},
            "model": {"num_blocks": 1, "num_filters": 8, "board_size": 4},
            "training": t,
            "mcts": {"num_simulations": 4, "dirichlet_epsilon": 0.0},
            "self_play": {"temperature_threshold": 0}, "system": {"seed": 7},
            "paths": {"checkpoint_dir": str(tmp_path / name / "models"),
                      "log_dir": str(tmp_path / name / "logs")}}


def capture_self_play(trainer, into):
    run = trainer.run_self_play

    def wrapped(n, **kw):
        into.append(run(n, **kw))
        return into[-1]

    trainer.run_self_play = wrapped


def test_train_iteration_matches_jax(tmp_path):
    """Same f32 weights, no root noise, argmax moves, and a buffer that holds
    exactly one batch (capacity == batch < one iteration's plies): every draw
    is a permutation of the whole buffer and each SGD step is order-invariant,
    so only the sample order is left free."""
    v = init_numpy_variables(1, 8, seed=11, board_size=4)
    jt = jtr.AlphaZeroTrainer(slice_config(tmp_path, "j"), log_cb=None,
                              model=JaxResNet(num_blocks=1, num_filters=8, board_size=4,
                                              dtype=jnp.float32))
    params = jax.tree.map(jnp.asarray, v["params"])
    jt.state = jt.state.replace(params=params,
                                batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                                opt_state=jt.tx.init(params))
    j_traj, t_traj = [], []
    capture_self_play(jt, j_traj)
    j_scalars = jt._train_iteration(0, 4, 1, [], [])
    jt.close()

    tt = ttr.AlphaZeroTrainer(slice_config(tmp_path, "t"), device="cpu",
                              compute_dtype=torch.float32, log_cb=None)
    tt.model.load_state_dict(from_jax_variables(v))
    capture_self_play(tt, t_traj)
    t_scalars = tt._train_iteration(0, 4, 1, [], [])
    tt.close()

    jtj, ttj = jax.device_get(j_traj[0]), t_traj[0]
    assert int(ttj.mask.sum()) > tt.buffer.capacity  # the ring overflowed
    np.testing.assert_array_equal(ttj.mask.numpy(), jtj.mask)
    np.testing.assert_array_equal(ttj.me.numpy(), to_i64(jtj.me))
    np.testing.assert_array_equal(ttj.value.numpy(), jtj.value)
    np.testing.assert_allclose(ttj.pi.numpy(), jtj.pi, rtol=0, atol=1e-6)
    jb = jax.device_get(jt.buffer)
    C = tt.buffer.capacity  # slot C is the trash slot (see test_torch_buffer.py)
    np.testing.assert_array_equal(tt.buffer.me[:C].numpy(), to_i64(jb.me[:C]))
    np.testing.assert_array_equal(tt.buffer.opp[:C].numpy(), to_i64(jb.opp[:C]))
    np.testing.assert_array_equal(tt.buffer.value[:C].numpy(), jb.value[:C])
    np.testing.assert_allclose(tt.buffer.pi[:C].numpy(), jb.pi[:C], rtol=0, atol=1e-6)
    assert (tt.buffer.cursor, tt.buffer.filled) == (int(jb.cursor), int(jb.filled))
    for k in ("Loss/train", "Loss/policy", "Loss/value", "Buffer/size",
              "Buffer/value_mean", "SelfPlay/avg_moves"):
        np.testing.assert_allclose(t_scalars[k], float(j_scalars[k]), rtol=1e-5, err_msg=k)
    assert tt.state.step == int(jt.state.step) == 3
    assert tt.state.iteration == int(jt.state.iteration) == 1
    assert_trees_close(tt.variables(), jax.device_get(jt.variables()), 1e-4, 1e-6)


# -- trainer orchestration: resume, checkpoints, self-healing ---------------------


def tiny_config(tmp_path, name, **training):
    t = {"batch_size": 16, "lr": 0.01, "num_iterations": 4, "self_play_episodes_per_iter": 4,
         "train_epochs_per_iter": 2, "checkpoint_interval": 2, "replay_buffer_size": 512}
    t.update(training)
    return {"game": {"size": 4, "rules": "reference"},
            "model": {"num_blocks": 1, "num_filters": 8, "board_size": 4},
            "training": t, "mcts": {"num_simulations": 2},
            "self_play": {"temperature_threshold": 3}, "system": {"seed": 7},
            "paths": {"checkpoint_dir": str(tmp_path / name / "models"),
                      "log_dir": str(tmp_path / name / "logs")}}


def trainer(cfg, **kw):
    return ttr.AlphaZeroTrainer(cfg, device="cpu", compute_dtype=torch.float32,
                                log_cb=kw.pop("log_cb", None), **kw)


def state_equal(a, b):
    assert a.keys() == b.keys()
    return all(torch.equal(x, b[k]) if isinstance(x, torch.Tensor) else x == b[k]
               for k, x in a.items())


@pytest.mark.parametrize("prioritized", [False, True])
def test_resume_bit_identical(tmp_path, prioritized):
    tr_a = trainer(tiny_config(tmp_path, "a", prioritized_replay=prioritized))
    tr_a.train()
    tr_a.close()
    tr_b = trainer(tiny_config(tmp_path, "b", prioritized_replay=prioritized))
    tr_b.train(num_iterations=2)
    tr_b.close()
    path = os.path.join(tr_b.checkpoint_dir, "checkpoint_iter_000002.pt")
    assert ckpt.load_meta(path)["format"] == 2
    tr_c = trainer(tiny_config(tmp_path, "b", prioritized_replay=prioritized))
    tr_c.load_checkpoint(path)
    assert tr_c.state.iteration == 2 and tr_c.buffer.filled == tr_b.buffer.filled > 0
    tr_c.train()
    tr_c.close()
    assert state_equal(tr_a.model.state_dict(), tr_c.model.state_dict())
    oa, oc = tr_a.state.optimizer.state_dict()["state"], tr_c.state.optimizer.state_dict()["state"]
    assert all(torch.equal(oa[i]["momentum_buffer"], oc[i]["momentum_buffer"]) for i in oa)
    assert tr_a.state.step == tr_c.state.step == 8
    assert torch.equal(tr_a.rng.get_state(), tr_c.rng.get_state())
    assert state_equal(tr_a.buffer.state_dict(), tr_c.buffer.state_dict()) \
        if not prioritized else torch.equal(tr_a.buffer.priority, tr_c.buffer.priority)
    for f in ("me", "opp", "pi", "value"):
        assert torch.equal(getattr(tr_a.buffer, f), getattr(tr_c.buffer, f))
    # final_model of both runs, and the metrics stream
    final = ckpt.latest_checkpoint(tr_c.checkpoint_dir)
    assert final.endswith("final_model.pt")
    assert ckpt.load_config(final)["training"]["prioritized_replay"] is prioritized
    with open(os.path.join(tr_a.log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert {r["tag"] for r in rows} >= {"Loss/train", "Buffer/size", "Time/self_play"}
    assert sorted({r["step"] for r in rows}) == [1, 2, 3, 4]


def test_format1_and_buffer_mismatch_checkpoints(tmp_path):
    logs = []
    tr = trainer(tiny_config(tmp_path, "x", num_iterations=1))
    tr.train()
    bare = ckpt.save(str(tmp_path / "x" / "bare.pt"), tr.state.state_dict())
    fresh = trainer(tiny_config(tmp_path, "y"), log_cb=logs.append)
    fresh.load_checkpoint(bare)
    assert fresh.buffer.filled == 0 and fresh.state.iteration == 1
    assert state_equal(fresh.model.state_dict(), tr.model.state_dict())
    assert any("format-1" in m for m in logs)
    other = trainer(tiny_config(tmp_path, "z", replay_buffer_size=256), log_cb=logs.append)
    other.load_checkpoint(os.path.join(tr.checkpoint_dir, "final_model.pt"))
    assert other.buffer.filled == 0 and other.buffer.capacity == 256
    assert state_equal(other.model.state_dict(), tr.model.state_dict())
    assert any("doesn't match config" in m for m in logs)


def heal_config(tmp_path, **kw):
    cfg = tiny_config(tmp_path, "heal", num_iterations=2, checkpoint_interval=1,
                      self_play_episodes_per_iter=2, batch_size=8)
    cfg["training"].update(kw)
    return cfg


def flaky(tr, fail_when):
    calls = {"n": 0}
    run = tr.run_self_play

    def wrapped(n, **kw):
        calls["n"] += 1
        if fail_when(calls["n"]):
            raise RuntimeError(f"injected fault {calls['n']}")
        return run(n, **kw)

    tr.run_self_play = wrapped
    return calls


def test_self_heal_recovers_from_transient_fault(tmp_path):
    tr = trainer(heal_config(tmp_path))
    calls = flaky(tr, lambda n: n == 2)  # after the first checkpoint
    metrics = tr.train()
    assert tr.state.iteration == 2 and calls["n"] == 3 and metrics["Loss/train"] > 0


def test_self_heal_rolls_back_before_first_checkpoint(tmp_path):
    ref = trainer(heal_config(tmp_path))
    ref.train()
    tr = trainer(heal_config(tmp_path))
    # fail after the buffer add and the SGD steps: the rollback must undo them
    ti = tr._train_iteration
    state = {"failed": False}

    def late_fault(*a):
        out = ti(*a)
        if not state["failed"]:
            state["failed"] = True
            raise RuntimeError("fault after a half-applied iteration")
        return out

    tr._train_iteration = late_fault
    tr.train()
    assert tr.state.iteration == 2 and tr.state.step == ref.state.step
    assert state_equal(tr.model.state_dict(), ref.model.state_dict())
    assert tr.buffer.filled == ref.buffer.filled


def test_self_heal_gives_up_after_bounded_retries(tmp_path):
    cfg = heal_config(tmp_path)
    cfg["system"]["max_recovery_retries"] = 2
    tr = trainer(cfg)
    calls = flaky(tr, lambda n: True)
    with pytest.raises(RuntimeError, match="injected fault 3"):
        tr.train()
    assert calls["n"] == 3  # the first try and two retries


@pytest.mark.parametrize("variant", ["matmul9", "int8_dx3"])
def test_fused_net_rebuilt_from_current_params(tmp_path, variant):
    """Self-play folds the weights of the parameters it plays with: each
    iteration's fused net holds the weights after the previous SGD."""
    tr = trainer(heal_config(tmp_path))
    tr.variant = variant
    seen = []
    build = tr.selfplay_net

    def spy():
        net = build()
        seen.append((net.trunk_w.clone(),
                     FusedInference(tr.model, variant=variant).trunk_w))
        return net

    tr.selfplay_net = spy
    tr.train()
    assert len(seen) == 2
    for net_w, model_w in seen:
        assert torch.equal(net_w, model_w)
    assert not torch.equal(seen[0][0], seen[1][0])


def test_self_play_in_chunks_of_num_parallel_games(tmp_path):
    cfg = tiny_config(tmp_path, "chunks")
    cfg["self_play"]["num_parallel_games"] = 3
    tr = trainer(cfg)
    traj = tr.run_self_play(4)  # a chunk of 3 games, then one of 1
    assert traj.mask.shape[0] == 4 and traj.pi.shape[:2] == traj.mask.shape
    assert torch.equal(traj.num_moves, traj.mask.sum(1).to(torch.int32))
    assert len({int(w) for w in traj.me[:, 3]}) > 1  # the chunks' games differ


@pytest.mark.parametrize("section,key,value,match", [
    ("system", "mesh_devices", 2, "--coordinator/--num-processes/--process-id"),
    ("system", "mesh_devices", 1, None),
])
def test_unported_options_raise(tmp_path, section, key, value, match):
    """``system.mesh_devices`` is the data-parallel world size, one process a
    device: 2 in a single process raises, naming how to start the ranks
    (``test_torch_parallel.py`` runs them); 1 is the single-process run."""
    cfg = tiny_config(tmp_path, "u", num_iterations=1)
    cfg[section][key] = value
    if match is None:
        assert trainer(cfg).train()["Loss/train"] > 0
        return
    with pytest.raises(ValueError, match=match) as e:
        trainer(cfg)
    assert "torchrun" in str(e.value)


def test_augmentation_off_under_reference_rules(tmp_path):
    logs = []
    tr = trainer(tiny_config(tmp_path, "aug", augment_symmetries=True), log_cb=logs.append)
    assert not tr.augment and any("not D4-symmetric" in m for m in logs)
    cfg = tiny_config(tmp_path, "aug2", augment_symmetries=True, num_iterations=1)
    cfg["game"]["rules"] = "standard"
    tr = trainer(cfg)
    assert tr.augment
    assert tr.train()["Loss/train"] > 0


def test_trainer_needs_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttr.AlphaZeroTrainer(tiny_config(tmp_path, "dev"), log_cb=None)


def test_metrics_writer_jsonl(tmp_path):
    w = MetricsWriter(str(tmp_path / "m"))
    w.scalar("Loss/train", 1.5, 3)
    w.close()
    with open(tmp_path / "m" / "metrics.jsonl") as f:
        row = json.loads(f.readline())
    assert (row["tag"], row["value"], row["step"]) == ("Loss/train", 1.5, 3)


def test_trainer_modules_import_no_jax():
    code = (
        "import sys\n"
        "import othello_reinforcement_learning_test_tpu_torch.train.trainer\n"
        "import othello_reinforcement_learning_test_tpu_torch.train.checkpoint\n"
        "import othello_reinforcement_learning_test_tpu_torch.train.buffer\n"
        "import othello_reinforcement_learning_test_tpu_torch.kernels.trunk_matmul9\n"
        "import othello_reinforcement_learning_test_tpu_torch.utils.metrics\n"
        "import othello_reinforcement_learning_test_tpu_torch.evaluation\n"
        "import othello_reinforcement_learning_test_tpu_torch.ops.native\n"
        "import othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dxcat\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'yaml', 'pydantic', "
        "'othello_reinforcement_learning_test_tpu')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
