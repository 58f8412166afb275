"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference takes nothing from the program; a run with no card, or with
only the benchmark's own files, prints no result."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from azbench import guard
from azbench.spec import HERE, ROOT

PROGRAM = "othello_reinforcement_learning_test_tpu_torch"


def test_top_level_names_are_compared_whole():
    assert guard.forbidden(["jax.numpy", "flax", "orbax.checkpoint", "optax"]) == [
        "flax", "jax", "optax", "orbax"]
    assert guard.forbidden([PROGRAM, f"{PROGRAM}.search.mcts", "jaxtyping", "torch"]) == []
    assert guard.forbidden(["othello_reinforcement_learning_test_tpu.models"]) == [
        "othello_reinforcement_learning_test_tpu"]


def test_sources_import_no_jax_and_the_reference_nothing_of_the_program():
    for path in HERE.rglob("*.py"):
        names = guard.imported_by(path)
        assert guard.forbidden(names) == [], path
        if "reference" in path.parts:
            assert {n.split(".")[0] for n in names} <= {"__future__", "typing", "torch"}, path


def test_a_dry_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        "from azbench import guard, run\n"
        "from azbench.tests.conftest import small\n"
        "run.run(small('flagship_r5.selfplay', games=64, sims=2, check_blocks=1), 5, 0.1, "
        "False, torch.device('cpu'), 0.0)\n"
        "print(guard.loaded(sys.modules), 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[] False"


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "azbench", "--workload",
                           "wide_10x256.selfplay", "--seed", str(2 ** 31 + 5), "--seconds", "1"],
                          cwd=cwd, capture_output=True, text=True, timeout=600, env=env)


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except ValueError:
            pass
    return False


def test_no_card_no_result():
    out = _run(ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and not _printed_result(out.stdout)


def test_benchmark_files_alone_give_no_result(tmp_path: Path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "azbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not _printed_result(out.stdout)


def test_unknown_cell_no_result():
    out = subprocess.run([sys.executable, "-m", "azbench", "--workload", "nothing", "--seed", "1",
                          "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0 and not _printed_result(out.stdout)
