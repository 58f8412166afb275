"""The port learns: the search's exploration root against JAX, the
learning-run script end to end on the CPU, and a resume across a ring wrap.

- ``_puct_best``: scores and actions equal bit for bit to the JAX
  ``_puct_best`` at node visits where PyTorch's vectorized f32 ``sqrt`` on
  the CPU is an ulp off (267, 999, 1068, 1171);
- ``scripts/torch_learning_run.py`` on ``configs/test.yaml`` at 3
  iterations resumed at 2, on the CPU: its record, the resumed run equal to
  an uninterrupted one, the curve with its anchor, no bar applied; its
  quotes of the JAX runs against their files;
- a resume after iteration 1 across a wrap of the ring equals the
  uninterrupted run in every leaf ``chip_smoke.py``'s phase ``learn``
  compares (``tests/test_torch_train.py``'s resume case never wraps: 4
  iterations of about 40 plies in a ring of 512).
"""

import contextlib
import io
import json
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.search import mcts as jm
from othello_reinforcement_learning_test_tpu_torch import cli
from othello_reinforcement_learning_test_tpu_torch.search import mcts as tm
from othello_reinforcement_learning_test_tpu_torch.train import trainer as ttr
from othello_reinforcement_learning_test_tpu_torch.utils import config as tconfig
from torch_resume import assert_resume_equal, differing_leaves, run_and_resume

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import torch_learning_run  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's intra-op pool at one thread: the games here are long chains
    of tiny ops, which many threads per worker turn into spin-waits when
    the test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """MetricsWriter writes TensorBoard files only when it imports; here
    that would pull in tensorflow (tens of seconds)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


# -- the exploration root ----------------------------------------------------------


class ArgmaxSpy:
    """A module whose ``argmax`` keeps its input: the PUCT scores."""

    def __init__(self, module):
        self.module, self.scores = module, None

    def __getattr__(self, name):
        return getattr(self.module, name)

    def argmax(self, x, *a, **kw):
        self.scores = x
        return self.module.argmax(x, *a, **kw)


def puct_tree(seed=0, B=4, N=16, A=65):
    """Numpy fields of a search tree whose node visits include 267, 999,
    1068 and 1171; edge visits and value sums consistent with them."""
    rng = np.random.default_rng(seed)
    visit = rng.integers(0, 2000, (B, N)).astype(np.int32)
    visit.flat[:4] = (267, 999, 1068, 1171)
    legal = rng.random((B, N, A)) < 0.3
    legal[..., 0] = True
    prior = np.where(legal, rng.random((B, N, A)), 0).astype(np.float32)
    prior /= prior.sum(-1, keepdims=True)
    share = rng.dirichlet(np.ones(A), (B, N)) * legal
    share /= share.sum(-1, keepdims=True)
    child_visit = np.floor(share * np.maximum(visit - 1, 0)[..., None]).astype(np.int32)
    child_value_sum = (child_visit * rng.uniform(-1, 1, (B, N, A))).astype(np.float32)
    children = np.where(child_visit > 0, rng.integers(1, N, (B, N, A)), -1)
    zeros = np.zeros((B, N), np.float32)
    return dict(visit=visit, prior=prior, children=children, child_visit=child_visit,
                child_value_sum=child_value_sum, legal=legal, value_sum=zeros,
                terminal=zeros.astype(bool), term_value=zeros, nn_value=zeros,
                num_nodes=np.full(B, N))


def test_puct_best_matches_jax_where_cpu_sqrt_misrounds(monkeypatch):
    f = puct_tree()
    B, N = f["visit"].shape
    jtree = jm.Tree(board_me=jnp.zeros((B, N, 2), jnp.uint32),
                    board_opp=jnp.zeros((B, N, 2), jnp.uint32),
                    **{k: jnp.asarray(v.astype(np.int32) if k in ("children", "num_nodes")
                                      else v) for k, v in f.items()})
    ttree = tm.Tree(board_me=torch.zeros((B, N), dtype=torch.int64),
                    board_opp=torch.zeros((B, N), dtype=torch.int64),
                    **{k: torch.from_numpy(v) for k, v in f.items()})
    jspy, tspy = ArgmaxSpy(jnp), ArgmaxSpy(torch)
    monkeypatch.setattr(jm, "jnp", jspy)
    monkeypatch.setattr(tm, "torch", tspy)
    j_act, j_child = jm._puct_best(jtree, 1.0)
    t_act, t_child = tm._puct_best(ttree, 1.0)
    np.testing.assert_array_equal(tspy.scores.numpy(), np.asarray(jspy.scores))
    np.testing.assert_array_equal(t_act.numpy(), np.asarray(j_act))
    np.testing.assert_array_equal(t_child.numpy(), np.asarray(j_child))


# -- the learning-run script -------------------------------------------------------


def test_jax_quotes_hold_to_their_files():
    """The script's JAX loss means and strength record, recomputed from the
    logs and the curve in ``results/``; its Wilson intervals."""
    for name, means in torch_learning_run.JAX_RUNS.items():
        first = {}
        for line in open(REPO / name):
            m = re.search(r"iter (\d+)/\d+ loss=([0-9.]+)", line)
            if m:
                first.setdefault(int(m.group(1)), float(m.group(2)))
        for end, mean in means.items():
            assert round(np.mean([first[i] for i in range(end - 4, end + 1)]), 3) == mean
    rec = torch_learning_run.JAX_CURVE
    curve = json.load(open(REPO / rec["file"]))
    row = next(r for r in curve["curve"] if r["iteration"] == rec["iteration"])
    assert (curve["games"], curve["simulations"]) == (rec["games"], rec["simulations"])
    for name in ("Random", "Greedy"):
        wins, games = rec[name]
        assert row[f"win_rate_vs_{name.lower()}"] == wins / games
    assert np.round(torch_learning_run.wilson(*rec["Random"]), 3).tolist() == [0.754, 0.924]
    assert np.round(torch_learning_run.wilson(*rec["Greedy"]), 3).tolist() == [0.791, 0.946]


def cpu_test_config(path: Path, root: Path, iterations: int) -> None:
    cfg = tconfig.load_config(str(REPO / "configs" / "test.yaml"))
    cfg["training"]["num_iterations"] = iterations
    cfg["paths"] = {"checkpoint_dir": str(root / "models"), "log_dir": str(root / "logs"),
                    "data_dir": str(root)}
    cfg["system"]["device"] = "cpu"
    path.write_text(tconfig.to_yaml(cfg))


def trainer_at(config: Path):
    """A trainer of ``config`` restored from its run's ``final_model``."""
    cfg = tconfig.load_config(str(config))
    tr = ttr.AlphaZeroTrainer(cfg, log_cb=None)
    tr.load_checkpoint(str(Path(cfg["paths"]["checkpoint_dir"]) / "final_model.pt"))
    tr.close()
    return tr


def test_learning_run_script_on_the_cpu(tmp_path):
    out = tmp_path / "learning_run.json"
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rc = torch_learning_run.main([
            "--config", str(REPO / "configs" / "test.yaml"), "--iterations", "3",
            "--resume-at", "2", "--anchor-iteration", "1", "--games", "2", "--simulations",
            "2", "--device", "cpu", "--workdir", str(tmp_path / "work"), "--out", str(out)])
    assert rc == 0
    data = json.load(open(out))
    assert data.keys() >= {"config", "iterations", "resume_at", "nvidia_smi", "iterations_log",
                           "loss_means", "jax_runs", "jax_curve", "resumed_from", "curve",
                           "matches", "bars_applied", "bars", "steps", "ok"}
    log = data["iterations_log"]
    assert [(r["iteration"], r["of"]) for r in log] == [(1, 2), (2, 2), (3, 3)]
    assert all(r.keys() >= {"loss", "self_play_s", "train_s", "buffer", "checkpoint_s"}
               for r in log)
    assert data["resumed_from"].endswith("final_model.pt at iteration 2")
    (row,) = data["curve"]
    assert row["iteration"] == 3 and "win_rate_vs_anchor" in row
    assert set(data["matches"]) == {"Random", "Greedy", "Anchor"}
    for m in data["matches"].values():
        assert m["wins"] + m["losses"] + m["draws"] == 2
        assert 0.0 <= m["wilson95"][0] <= m["wins"] / 2 <= m["wilson95"][1] <= 1.0
    assert data["bars_applied"] is False and data["bars"] is None and data["ok"] is True
    assert "figures in" in text.getvalue()

    # the same config trained 3 iterations in one run
    path = tmp_path / "straight.yaml"
    cpu_test_config(path, tmp_path / "straight", 3)
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["train", "--config", str(path)])
    resumed = trainer_at(tmp_path / "work" / "config.yaml")
    straight = trainer_at(path)
    assert resumed.state.iteration == straight.state.iteration == 3
    assert differing_leaves(resumed, straight) == []


# -- a resume across a ring wrap ---------------------------------------------------


def test_resume_across_a_ring_wrap(tmp_path):
    a, b, resumed_plies = run_and_resume(tmp_path, "cpu", compute_dtype=torch.float32)
    assert_resume_equal(a, b, resumed_plies)
