"""One rank of the port's multi-process CPU tests (``test_torch_parallel.py``).

    python tests/torch_mp_worker.py MODE RANK WORLD PORT OUTDIR [EXTRA]

Joins a gloo process group over ``tcp://127.0.0.1:PORT`` (collective
timeout 30 s) with one torch thread, runs MODE, writes
``OUTDIR/result_{RANK}.json`` (tensors beside it as ``.pt`` files), and
then ends in a fail-fast run: a trainer with a fault injected in iteration
2, on rank 0 alone after ``core``, on both ranks after ``train``. A
faulting rank exits 17, its peer non-zero; neither heals. Imports torch,
numpy and the port only: no JAX. The parent test holds the results to the
JAX package's mesh runs and to the port's single-process runs. Modes:

  core   the 2-rank f64 SGD step; ``global`` self-play with the stub
         network, without and with root noise and sampling, at
         cond_interval 1, 2 and 4; sharded arena matches; the collectives
         on uneven shares;
  train  trainer iterations (``local``, ``global``, prioritized), a gated
         iteration and a further gate match, then resume: 4 iterations
         uninterrupted, and 2 iterations, a fresh process group, and
         ``cli train --coordinator 127.0.0.1:EXTRA ... --resume latest``
         to 4.
"""

import contextlib
import hashlib
import io
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# MetricsWriter writes TensorBoard files only when it imports; here that
# would pull in tensorflow (seconds a process). The JSONL stream is written
# either way.
sys.modules["torch.utils.tensorboard"] = None

from othello_reinforcement_learning_test_tpu_torch.models.convert import (  # noqa: E402
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine  # noqa: E402
from othello_reinforcement_learning_test_tpu_torch.parallel import mesh  # noqa: E402

SGD_CFG = {"training": {"lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}}
SGD_BATCH = 32
SELFPLAY = dict(num_games=8, num_simulations=2)
ARENA_GAMES = 8


# -- inputs shared with the parent test ----------------------------------------------


def sgd_inputs():
    """The SGD step's weights (2 blocks x 8 filters, a state dict) and its
    32 buffer entries: boards after random plies (int64 words), pi, value."""
    eng = get_engine(8)
    rng = np.random.default_rng(0)
    b = eng.initial_state((SGD_BATCH,), device="cpu")
    for ply in range(int(rng.integers(6, 12))):
        legal = eng.legal_actions(b).numpy()
        a = torch.tensor([rng.choice(np.flatnonzero(r)) for r in legal])
        b, _ = eng.step(b, a)
    pi = rng.random((SGD_BATCH, 65))
    pi /= pi.sum(-1, keepdims=True)
    value = rng.choice(np.array([-1.0, 0.0, 1.0]), SGD_BATCH)
    sd = from_jax_variables(init_numpy_variables(2, 8, seed=4))
    return sd, b.me, b.opp, torch.from_numpy(pi.astype(np.float32)), torch.from_numpy(
        value.astype(np.float32))


def sgd_step(sd, me, opp, pi, value):
    """One port f64 SGD step through ``train_steps`` on a buffer that holds
    exactly the batch (so the whole buffer is the minibatch): the new state
    dict and the step's losses."""
    from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet
    from othello_reinforcement_learning_test_tpu_torch.train import buffer as buffer_lib
    from othello_reinforcement_learning_test_tpu_torch.train import trainer as ttr
    from othello_reinforcement_learning_test_tpu_torch.train.self_play import Trajectory

    m = OthelloResNet(2, 8)
    m.load_state_dict(sd)
    m.to(torch.float64)
    state = ttr.TrainState(m, ttr.make_optimizer(m, SGD_CFG))
    buf = buffer_lib.create(SGD_BATCH, 65, device="cpu")
    n = SGD_BATCH
    buffer_lib.add(buf, Trajectory(me=me[:, None], opp=opp[:, None], pi=pi[:, None],
                                   value=value[:, None], mask=torch.ones(n, 1, dtype=torch.bool),
                                   final_me_count=torch.zeros(n, dtype=torch.int32),
                                   final_opp_count=torch.zeros(n, dtype=torch.int32),
                                   winner_black=torch.zeros(n, dtype=torch.int32),
                                   num_moves=torch.ones(n, dtype=torch.int32)))
    gen = torch.Generator().manual_seed(3)
    (metrics,) = ttr.train_steps(state, get_engine(8), buf, gen, SGD_BATCH, 1,
                                 ttr.make_lr_schedule(SGD_CFG), compute_dtype=torch.float64)
    return ({k: t.clone() for k, t in m.state_dict().items()},
            {k: float(v) for k, v in metrics.items()})


def stub_net():
    from torch_stub_net import stub_weights, torch_stub

    return torch_stub(stub_weights(8, seed=8))


def self_play(shard=None, noise=False, cond_interval=1):
    from othello_reinforcement_learning_test_tpu_torch.train.self_play import play_games

    kw = (dict(add_noise=True, temperature_threshold=6) if noise
          else dict(add_noise=False, temperature_threshold=0))
    return play_games(get_engine(8), stub_net(), SELFPLAY["num_games"],
                      SELFPLAY["num_simulations"], seed=11, device="cpu",
                      cond_interval=cond_interval, shard=shard, **kw)


def arena_matches(shard=None):
    """Three matches: MCTS on the stub network (2 simulations) against
    Greedy and Random against Greedy, both with 4 random opening plies, and
    Greedy against Greedy with none. Each as (wins, losses, draws, per-game
    winner, p1 score, p2 score, moves)."""
    from othello_reinforcement_learning_test_tpu_torch.evaluation import (
        Arena,
        GreedyPlayer,
        MCTSPlayer,
        RandomPlayer,
    )

    eng = get_engine(8)
    arena = Arena(eng, device="cpu", shard=shard)
    out = []
    for p1, plies in ((MCTSPlayer(eng, stub_net(), num_simulations=2), 4),
                      (RandomPlayer(eng), 4), (GreedyPlayer(eng), 0)):
        s = arena.play_matches(p1, GreedyPlayer(eng), ARENA_GAMES, seed=5,
                               opening_random_plies=plies)
        out.append([s.wins, s.losses, s.draws, [r.winner for r in s.results],
                    [r.player1_score for r in s.results],
                    [r.player2_score for r in s.results],
                    [r.num_moves for r in s.results]])
    return out


# -- trainer runs -------------------------------------------------------------------


def tiny_config(outdir, name, **training):
    t = {"batch_size": 16, "lr": 0.01, "num_iterations": 1, "self_play_episodes_per_iter": 4,
         "train_epochs_per_iter": 2, "checkpoint_interval": 100, "replay_buffer_size": 256}
    t.update(training)
    return {"game": {"size": 4, "rules": "reference"},
            "model": {"num_blocks": 1, "num_filters": 8, "board_size": 4},
            "training": t, "mcts": {"num_simulations": 2},
            "self_play": {"temperature_threshold": 2},
            "system": {"seed": 11, "device": "cpu", "mesh_devices": 2},
            "paths": {"checkpoint_dir": os.path.join(outdir, name, "models"),
                      "log_dir": os.path.join(outdir, name, "logs")}}


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def digests(tr):
    sd = tr.model.state_dict()
    opt = tr.state.optimizer.state_dict()["state"]
    buf = tr.buffer.state_dict()
    return {"params": _digest(sd[k] for k in sorted(sd)),
            "opt": _digest(opt[k]["momentum_buffer"] for k in sorted(opt)),
            "rng": _digest([tr.rng.get_state(), tr.sample_rng.get_state()]),
            "buffer": _digest(v for k, v in sorted(buf.items()) if isinstance(v, torch.Tensor)),
            "filled": int(tr.buffer.filled), "cursor": int(tr.buffer.cursor),
            "iteration": tr.state.iteration, "step": tr.state.step}


def trainer(cfg, logs=None):
    """The trainer as the CLI builds it (bf16 compute), logging into ``logs``."""
    from othello_reinforcement_learning_test_tpu_torch.train.trainer import AlphaZeroTrainer

    return AlphaZeroTrainer(cfg, log_cb=None if logs is None else logs.append)


def run_core(outdir, rank, world):
    out = {}
    sd, me, opp, pi, value = sgd_inputs()
    new_sd, losses = sgd_step(sd, me, opp, pi, value)
    torch.save(new_sd, os.path.join(outdir, f"sgd_{rank}.pt"))
    out["sgd_losses"] = losses

    trajs = {"plain": self_play(shard=(rank, world)),
             "noise": self_play(shard=(rank, world), noise=True)}
    for k in (2, 4):
        trajs[f"noise_k{k}"] = self_play(shard=(rank, world), noise=True, cond_interval=k)
    gathered = {k: tuple(mesh.all_gather_leading(t)) for k, t in trajs.items()}
    torch.save({k: tuple(t) for k, t in trajs.items()}, os.path.join(outdir, f"local_{rank}.pt"))
    torch.save(gathered, os.path.join(outdir, f"selfplay_{rank}.pt"))

    out["arena"] = arena_matches(shard=(rank, world))

    # the collectives on uneven shares, in rank order
    n = 3 - rank
    tree = {"a": torch.arange(n) + 10 * rank, "b": (torch.full((n, 2), rank == 1),)}
    g = mesh.all_gather_leading(tree)
    out["gathered"] = [g["a"].tolist(), g["b"][0].tolist()]
    x = torch.full((3,), float(rank + 1))
    mesh.broadcast(x, src=1)
    out["broadcast"] = x.tolist()
    out["seed"] = mesh.fold_in_process(7)
    out["local_slice"] = [mesh.local_slice(5).start, mesh.local_slice(5).stop]
    return out


def run_train(outdir, rank, world, cli_port):
    from othello_reinforcement_learning_test_tpu_torch import cli
    from othello_reinforcement_learning_test_tpu_torch.train import trainer as ttr
    from othello_reinforcement_learning_test_tpu_torch.utils.config import to_yaml

    out = {}
    for design, prioritized in (("local", False), ("global", False), ("local", True)):
        name = f"{design}{'_prio' if prioritized else ''}"
        cfg = tiny_config(outdir, name, prioritized_replay=prioritized)
        cfg["system"]["distributed_self_play"] = design
        tr = trainer(cfg)
        seeds = []
        play = tr._play

        def spy(net, num_games, add_noise, seed, **kw):
            seeds.append(seed)
            return play(net, num_games, add_noise, seed, **kw)

        tr._play = spy
        tr.train()
        tr.close()
        out[name] = {**digests(tr), "seeds": [str(s) for s in seeds]}

    cfg = tiny_config(outdir, "gate", checkpoint_interval=1, gating={
        "enabled": True, "games": 8, "win_threshold": 0.55, "interval": 1,
        "num_simulations": 2, "opening_random_plies": 2})
    tr = trainer(cfg)
    tr.train()
    win_rate, s = tr._gate_match(5)
    tr.close()
    out["gate"] = {"decision": bool(win_rate >= tr.gating_threshold), "win_rate": win_rate,
                   "wld": [s.wins, s.losses, s.draws], "games": len(s.results),
                   "best": _digest(tr.best[k] for k in sorted(tr.best))}

    full = tiny_config(outdir, "full", num_iterations=4, checkpoint_interval=2)
    tr = trainer(full)
    tr.train()
    tr.close()
    out["full"] = digests(tr)
    part = tiny_config(outdir, "part", num_iterations=4, checkpoint_interval=2)
    tr = trainer(part)
    tr.train(num_iterations=2)
    tr.close()
    out["part1"] = digests(tr)

    # a fresh process group, started by the CLI, resumes to iteration 4
    torch.distributed.destroy_process_group()
    path = os.path.join(outdir, f"part_{rank}.yaml")
    with open(path, "w") as f:
        f.write(to_yaml(part))
    kept = []
    train = ttr.AlphaZeroTrainer.train

    def keep(self, *a, **kw):
        kept.append(self)
        return train(self, *a, **kw)

    ttr.AlphaZeroTrainer.train = keep
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cli.main(["train", "--config", path, "--resume", "latest",
                  "--coordinator", f"127.0.0.1:{cli_port}",
                  "--num-processes", str(world), "--process-id", str(rank)])
    out["part2"] = digests(kept[0])
    out["cli_log"] = text.getvalue()
    return out


def run_failfast(outdir, rank, which):
    """Never returns: exits 17 on the injected fault, raises on the peer's."""
    msgs = []
    tr = trainer(tiny_config(outdir, "ff", num_iterations=3), logs=msgs)
    orig = tr._train_iteration
    faulty = which == "both" or rank == 0

    def poisoned(it, *args, **kwargs):
        if it == 1 and faulty:
            raise RuntimeError("injected fault")
        return orig(it, *args, **kwargs)

    tr._train_iteration = poisoned
    try:
        tr.train()
    except BaseException as e:
        print("\n".join(msgs), flush=True)
        if "injected fault" not in str(e):
            raise  # the peer's failure, seen in a collective: a non-zero exit
        assert any("re-raising" in m for m in msgs), msgs
        sys.stdout.flush()
        os._exit(17)
    raise AssertionError("the fault-injected run finished")


def main():
    mode, rank, world, port, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4], sys.argv[5]
    extra = sys.argv[6] if len(sys.argv) > 6 else None
    torch.set_num_threads(1)
    mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu", timeout=30)
    assert mesh.process_count() == world and torch.distributed.get_backend() == "gloo"
    if mode == "core":
        out, faulty = run_core(outdir, rank, world), "rank0"
    elif mode == "train":
        out, faulty = run_train(outdir, rank, world, extra), "both"
    else:
        raise SystemExit(f"unknown mode {mode}")
    out["rank"] = rank
    with open(os.path.join(outdir, f"result_{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"rank {rank}: results written; fail-fast run with a fault on {faulty}", flush=True)
    run_failfast(outdir, rank, faulty)


if __name__ == "__main__":
    main()
