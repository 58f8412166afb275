"""What a resume must restore, and a run that resumes across a ring wrap.

Shared by the resume checks on the CPU (``test_torch_learning.py``), on the
card (``test_torch_cuda.py``) and ``chip_smoke.py``'s phase ``learn``.
Imports torch and the port only (no JAX).
"""

import json
from pathlib import Path

import torch

from othello_reinforcement_learning_test_tpu_torch.train import trainer as ttr


def resume_leaves(tr) -> dict:
    """What a resume must restore, on the CPU: every parameter and BatchNorm
    statistic, every SGD momentum buffer, the step and iteration, both
    generators (host and device), the ring's C slots and its cursor, fill
    and count. The ring's extra slot C, where ``buffer.add`` sends the
    masked-out plies, is left out: which of them lands there last is not
    defined on the card (an ``index_put_`` with repeated indices), and
    nothing reads it."""
    leaves = {f"model.{k}": t for k, t in tr.model.state_dict().items()}
    for i, s in tr.state.optimizer.state_dict()["state"].items():
        leaves[f"momentum.{i}"] = s["momentum_buffer"]
    C = tr.buffer.capacity
    for f in ("me", "opp", "pi", "value"):
        leaves[f"buffer.{f}"] = getattr(tr.buffer, f)[:C]
    leaves.update({
        "rng.host": tr.rng.get_state(), "rng.device": tr.sample_rng.get_state(),
        "counters": torch.tensor([tr.state.step, tr.state.iteration, tr.buffer.cursor,
                                  tr.buffer.filled, tr.buffer.total_added])})
    return {k: t.detach().cpu() for k, t in leaves.items()}


def differing_leaves(a, b) -> list:
    """The names of the leaves in which two trainers differ."""
    la, lb = resume_leaves(a), resume_leaves(b)
    assert la.keys() == lb.keys()
    return [k for k in la if not torch.equal(la[k], lb[k])]


def metric_log(log_dir) -> list:
    """(step, tag, value) of every row in ``log_dir/metrics.jsonl``."""
    with open(Path(log_dir) / "metrics.jsonl") as f:
        return [(r["step"], r["tag"], r["value"]) for r in map(json.loads, f)]


def compared_rows(log_dir, step: int) -> list:
    """The rows of ``step`` but the wall times (``Time/...``), which no two
    runs share."""
    return [r for r in metric_log(log_dir) if r[0] == step and not r[1].startswith("Time/")]


def wrap_config(root: Path, run: str, device: str) -> dict:
    """A 1x8 network on 4x4 boards, 8 games of 2 simulations an iteration
    (about 90 plies), a ring of 128 positions, so that it wraps in
    iteration 2; a checkpoint every iteration."""
    return {"game": {"size": 4, "rules": "reference"},
            "model": {"num_blocks": 1, "num_filters": 8, "board_size": 4},
            "training": {"batch_size": 16, "lr": 0.01, "num_iterations": 2,
                         "self_play_episodes_per_iter": 8, "train_epochs_per_iter": 3,
                         "checkpoint_interval": 1, "replay_buffer_size": 128},
            "mcts": {"num_simulations": 2}, "self_play": {"temperature_threshold": 3},
            "system": {"seed": 11, "device": device, "max_recovery_retries": 0},
            "paths": {"checkpoint_dir": str(root / run / "models"),
                      "log_dir": str(root / run / "logs")}}


def run_and_resume(root: Path, device: str, **kw):
    """Run A: iterations 1-2 uninterrupted; run B: a fresh trainer that
    loads A's checkpoint of iteration 1 and trains to 2. Returns (A, B, the
    plies in B's ring when it resumed)."""
    a = ttr.AlphaZeroTrainer(wrap_config(root, "A", device), log_cb=None, **kw)
    a.train()
    a.close()
    b = ttr.AlphaZeroTrainer(wrap_config(root, "B", device), log_cb=None, **kw)
    b.load_checkpoint(str(root / "A" / "models" / "checkpoint_iter_000001.pt"))
    resumed_plies = b.buffer.total_added
    b.train()
    b.close()
    return a, b, resumed_plies


def assert_resume_equal(a, b, resumed_plies: int) -> None:
    """B resumed at iteration 1, the ring wrapped after it, and A and B end
    equal in every leaf of :func:`resume_leaves` and in iteration 2's
    metrics rows."""
    C = a.buffer.capacity
    assert resumed_plies < C < a.buffer.total_added and a.buffer.filled == C
    assert a.state.step == 2 * a.epochs_per_iter
    assert differing_leaves(a, b) == []
    rows = compared_rows(a.log_dir, 2)
    assert rows and rows == compared_rows(b.log_dir, 2)
