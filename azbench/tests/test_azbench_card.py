"""The benchmark on the card: each cell runs, checks itself correct and
reports its metrics (run on a machine with a card:
``python3 -m pytest azbench/tests -m cuda``)."""

import json
import subprocess
import sys

import pytest

from azbench.spec import BENCHMARK, ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(BENCHMARK.read_text())["workloads"]])
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_on_the_card(card, cell, traced):
    out = subprocess.run([sys.executable, "-m", "azbench", "--workload", cell, "--seed",
                          str(2 ** 31 + 17), "--seconds", "3", "--trace", str(traced)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    names = {"search_positions_per_s", "setup_s"} if not traced else {
        "ops_per_sim.search", "forward_ms.search", "trunk_roofline.search", "idle_pct.search",
        "mfu.search"}
    assert set(result["metrics"]) == names
    if traced:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["metrics"]["trunk_roofline.search"]["value"] <= 100
