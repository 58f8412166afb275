"""The port's strength studies (``..._torch/studies/``) against the JAX
package's research scripts, on the CPU.

1. ``bt_fit`` on the pairs of ``results/elo_ladder.json`` equals the JAX
   script's ``bt_fit`` (rtol 1e-12), and ``fit_and_report`` on a copy of the
   record gives its ``ratings`` exactly and the rows of both tables of
   ``results/elo_ladder.md`` exactly;
2. every ``--phase`` of the ladder and of the standard-rules arena plays
   the JAX script's pairs at its game counts, and ``--fit`` fits (each
   JAX ``main()`` run with its play and fit functions replaced, so nothing
   is played);
3. each ``eval_flagship`` preset plays the JAX script's opponents, game
   counts, seeds and opening plies and prints its JSON lines for the same
   match results (both arenas and both checkpoint loaders replaced);
4. the pair loop end to end with tiny 1x8 networks (reference-format and
   port ``.pt`` files in a ``--networks`` directory), 2 simulations, 4
   games: the record's schema and protocol, the crc32 seeds, a cached pair
   skipped, a pair another writer added in between kept; the standard
   arena under the standard rules with no protocol block;
5. the network lookup and the device: a name neither shipped nor in
   ``--networks`` raises, naming the conversion command; CUDA asked for
   without a card raises; the score bands;
6. the four modules import with jax and the JAX package blocked.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import zlib
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu.evaluation import arena as jarena
from othello_reinforcement_learning_test_tpu.evaluation import players as jplayers
from othello_reinforcement_learning_test_tpu_torch import trained
from othello_reinforcement_learning_test_tpu_torch.evaluation.arena import Arena
from othello_reinforcement_learning_test_tpu_torch.evaluation.players import MCTSPlayer
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet
from othello_reinforcement_learning_test_tpu_torch.studies import (
    common,
    elo_ladder,
    eval_flagship,
    standard_rules_arena,
)
from othello_reinforcement_learning_test_tpu_torch.train import checkpoint as tckpt

REPO = Path(__file__).resolve().parents[1]
MODULES = ("common", "elo_ladder", "standard_rules_arena", "eval_flagship")
ROW_KEYS = {"wins_a", "wins_b", "draws", "n", "wall_s"}


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's intra-op pool at one thread, as in ``test_torch_cli.py``:
    the test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ladder_record():
    with open(REPO / "results" / "elo_ladder.json") as f:
        return json.load(f)


# -- the fit -------------------------------------------------------------------


def test_bt_fit_equals_jax(ladder_record):
    pairs = ladder_record["pairs"]
    names = sorted({n for key in pairs for n in key.split("|")})
    r, idx, rows = elo_ladder.bt_fit(pairs, names)
    r_j, idx_j, rows_j = jax_script("elo_ladder").bt_fit(pairs, names)
    assert idx == idx_j and rows == rows_j and len(names) == 22 and len(rows) == 100
    np.testing.assert_allclose(r, r_j, rtol=1e-12, atol=0)


def test_fit_and_report_gives_the_record(tmp_path, ladder_record):
    out = tmp_path / "elo_ladder.json"
    shutil.copy(REPO / "results" / "elo_ladder.json", out)
    table = elo_ladder.fit_and_report(str(out), str(tmp_path / "elo_ladder.md"))
    got = json.loads(out.read_text())
    assert got["ratings"] == ladder_record["ratings"]
    assert list(got["ratings"]) == list(ladder_record["ratings"]) == [t[0] for t in table]
    assert got["pairs"] == ladder_record["pairs"] and got["protocol"] == ladder_record["protocol"]

    def rows(text):
        return [line for line in text.splitlines() if line.startswith("|")]

    want = rows((REPO / "results" / "elo_ladder.md").read_text())
    assert len(want) == 2 + 22 + 2 + 21  # header and rule, 22 players; 21 adjacent pairs
    assert rows((tmp_path / "elo_ladder.md").read_text()) == want


# -- pair sets ---------------------------------------------------------------


LADDER_ARGV = [["--phase", "tpu"], ["--phase", "cpu"], ["--phase", "top"],
               ["--phase", "parity"], ["--fit"],
               ["--phase", "cpu", "--games", "7", "--connect-games", "3", "--fit"],
               ["--phase", "top", "--games", "300"]]
ARENA_ARGV = [["--phase", "tpu"], ["--phase", "cpu"],
              ["--phase", "tpu", "--games", "400"], ["--phase", "cpu", "--connect-games", "5"]]


def captured_plays(monkeypatch, module, play_name, argv, jax_side):
    """[(pairs, games)] that ``module.main`` plays for ``argv``, and the
    fits it runs, with play and fit replaced."""
    plays, fits = [], []
    monkeypatch.setattr(module, play_name,
                        lambda pairs, games, out, *a, **k: plays.append((list(pairs), games)))
    if hasattr(module, "fit_and_report"):
        monkeypatch.setattr(module, "fit_and_report", lambda out, md: fits.append((out, md)))
    if jax_side:
        monkeypatch.setattr(sys, "argv", [play_name, *argv])
        module.main()
    else:
        module.main([*argv, "--device", "cpu"])
    return plays, fits


@pytest.mark.parametrize("argv", LADDER_ARGV, ids=" ".join)
def test_ladder_phases_play_the_jax_pairs(argv, monkeypatch, tmp_path):
    out = str(tmp_path / "ladder.json")
    want, want_fits = captured_plays(monkeypatch, jax_script("elo_ladder"), "play_phase",
                                     [*argv, "--out", out], jax_side=True)
    got, fits = captured_plays(monkeypatch, elo_ladder, "play_phase", [*argv, "--out", out],
                               jax_side=False)
    assert got == want and (got or "--fit" in argv)
    assert len(fits) == len(want_fits) == ("--fit" in argv)
    if fits:
        assert fits[0] == (out, str(tmp_path / "ladder.md"))


@pytest.mark.parametrize("argv", ARENA_ARGV, ids=" ".join)
def test_standard_arena_phases_play_the_jax_pairs(argv, monkeypatch, tmp_path):
    out = str(tmp_path / "sym.json")
    want, _ = captured_plays(monkeypatch, jax_script("standard_rules_arena"), "play",
                             [*argv, "--out", out], jax_side=True)
    got, _ = captured_plays(monkeypatch, standard_rules_arena, "play", [*argv, "--out", out],
                            jax_side=False)
    assert got == want and got


def test_pair_sets_are_the_records_pairs(ladder_record):
    """The top pairs and the standard head to head are recorded pairs."""
    (top, _), = elo_ladder.pair_sets("top", 300, 24)
    assert all(ladder_record["pairs"][f"{a}|{b}"]["n"] == 300 for a, b in top) and len(top) == 6
    sym = trained.study_record("symmetry_ablation")["pairs"]
    (tpu, _), = standard_rules_arena.pair_sets("tpu", 120, 24)
    assert [f"{a}|{b}" for a, b in tpu] == list(sym)[:5]


# -- eval_flagship ---------------------------------------------------------------


def fake_summary(i, n):
    """Match i's result: one match all draws, the others mixed."""
    wins, losses = (0, 0) if i == 1 else (n // 2 - i, n // 3)
    return SimpleNamespace(wins=wins, losses=losses, draws=n - wins - losses)


@pytest.mark.parametrize("preset,script", [("r4", "eval_flagship_r4"),
                                           ("r5_ext", "eval_flagship_r5_ext")])
@pytest.mark.parametrize("games", [None, 6])
def test_eval_flagship_preset_equals_jax(preset, script, games, monkeypatch, capsys, tmp_path):
    extra = [] if games is None else ["--games", str(games)]

    def run(module_cls_arena, loader_owner, seed_of, main):
        calls = []

        def play_matches(self, p1, p2, n, seed, opening_random_plies=0):
            calls.append((p1.name, p2.name, n, seed_of(seed), opening_random_plies))
            return fake_summary(len(calls) - 1, n)

        monkeypatch.setattr(module_cls_arena, "play_matches", play_matches)
        monkeypatch.setattr(loader_owner, "from_checkpoint", classmethod(
            lambda cls, path, *a, **k: SimpleNamespace(name=Path(path).stem)))
        capsys.readouterr()
        main()
        return calls, capsys.readouterr().out.splitlines()

    for stem in ("model_strong_8x8_500iter", "model_10x128_600iter_gated"):  # not shipped
        (tmp_path / f"{stem}.pt").touch()
    jax_main = jax_script(script).main
    monkeypatch.setattr(sys, "argv", [script, "--ckpt", "flagship_r4", *extra])
    want_calls, want_lines = run(jarena.Arena, jplayers.MCTSPlayer,
                                 lambda key: int(np.asarray(key)[-1]), jax_main)
    got_calls, got_lines = run(Arena, MCTSPlayer, int, lambda: eval_flagship.main(
        ["--preset", preset, "--ckpt", "flagship_r4.pt", "--networks", str(tmp_path),
         "--device", "cpu", *extra]))
    # opponents by name: the JAX networks' directory names, the port's .pt
    # stems; Greedy and Random by their players' names
    assert [c[2:] for c in got_calls] == [c[2:] for c in want_calls]
    assert [c[:2] for c in got_calls] == [c[:2] for c in want_calls]
    assert [json.loads(x) for x in got_lines] == [json.loads(x) for x in want_lines]
    assert got_lines == want_lines and len(got_lines) == len(eval_flagship.PRESETS[preset][
        "opponents"])


# -- the pair loop end to end ---------------------------------------------------------


def tiny_networks(directory, names, port_format=()):
    """1x8 networks at ``<directory>/<name>.pt``: reference-format files, or
    port checkpoints for the names in ``port_format``."""
    os.makedirs(directory, exist_ok=True)
    for i, name in enumerate(names):
        torch.manual_seed(i)
        sd = OthelloResNet(1, 8, 8).state_dict()
        path = os.path.join(directory, f"{name}.pt")
        if name in port_format:
            cfg = {"model": {"num_blocks": 1, "num_filters": 8}, "game": {"size": 8}}
            tckpt.save(path, {"model": sd, "step": 0, "iteration": 0}, cfg)
        else:
            torch.save({"model_state_dict": sd}, path)


@pytest.fixture
def recorded_matches(monkeypatch):
    """Every match the port's arena plays: (engine rules, player names,
    games, seed, opening plies)."""
    calls = []
    real = Arena.play_matches

    def play_matches(self, p1, p2, n, seed=0, opening_random_plies=0):
        calls.append((self.engine.rules, p1, p2, n, seed, opening_random_plies))
        return real(self, p1, p2, n, seed, opening_random_plies=opening_random_plies)

    monkeypatch.setattr(Arena, "play_matches", play_matches)
    return calls


def test_ladder_pair_loop_end_to_end(tmp_path, monkeypatch, recorded_matches):
    nets = tmp_path / "nets"
    tiny_networks(nets, ["ref_seed7", "repo_seed7", "ref_seed77", "repo_seed77"],
                  port_format=("repo_seed7",))
    out = tmp_path / "ladder.json"
    cached = {"wins_a": 1, "wins_b": 2, "draws": 1, "n": 4, "wall_s": 0.5}
    common.write_results(str(out), {"protocol": common.PROTOCOL,
                                    "pairs": {"ref-parity-s77|repo-parity-s77": cached}})
    other = {"wins_a": 3, "wins_b": 0, "draws": 0, "n": 3, "wall_s": 1.0}

    def another_writer():
        if len(recorded_matches) == 1:  # between the first pair's start and its save
            rec = json.loads(out.read_text())
            rec["pairs"]["greedy|random"] = other
            out.write_text(json.dumps(rec))

    recording = Arena.play_matches
    monkeypatch.setattr(Arena, "play_matches",
                        lambda *a, **k: (recording(*a, **k), another_writer())[0])
    pairs = [("ref-parity-s7", "repo-parity-s7"), ("ref-parity-s77", "repo-parity-s77"),
             ("repo-parity-s7", "greedy")]
    elo_ladder.play_phase(pairs, 4, str(out), networks=str(nets), device="cpu", sims=2)
    rec = json.loads(out.read_text())
    assert rec["protocol"] == common.PROTOCOL == {
        "games": "see per-pair n", "simulations": 100, "opening_random_plies": 4,
        "colors": "alternate per game"}
    assert rec["pairs"]["ref-parity-s77|repo-parity-s77"] == cached
    assert rec["pairs"]["greedy|random"] == other
    played = ["ref-parity-s7|repo-parity-s7", "repo-parity-s7|greedy"]
    assert [(c[0], c[3], c[4], c[5]) for c in recorded_matches] == [
        ("reference", 4, zlib.crc32(k.encode()), 4) for k in played]
    p1, p2 = recorded_matches[0][1:3]
    assert p1.model.num_blocks == 1 and p2.num_simulations == 2
    for key in played:
        row = rec["pairs"][key]
        assert set(row) == ROW_KEYS and row["n"] == 4
        assert row["wins_a"] + row["wins_b"] + row["draws"] == 4 and row["wall_s"] >= 0


def test_standard_arena_end_to_end(tmp_path, recorded_matches):
    """Under the standard rules, the networks from ``--networks``; the
    record has no protocol block, as the JAX one."""
    nets = tmp_path / "nets"
    tiny_networks(nets, ["model_10x128_500iter_symaug", "model_10x128_500iter_symbase"])
    out = tmp_path / "sym.json"
    standard_rules_arena.play([("sym-aug", "sym-base"), ("sym-aug", "random")], 4, str(out),
                              networks=str(nets), device="cpu", sims=2)
    rec = json.loads(out.read_text())
    assert list(rec) == ["pairs"] and list(rec["pairs"]) == ["sym-aug|sym-base", "sym-aug|random"]
    assert all(set(r) == ROW_KEYS for r in rec["pairs"].values())
    assert [c[0] for c in recorded_matches] == ["standard", "standard"]
    assert recorded_matches[0][1].engine.rules == "standard"


# -- lookup, device, bands -------------------------------------------------------------


def test_shipped_networks_resolve_by_ladder_name():
    shipped = common.shipped_networks()
    assert sorted(shipped) == ["net-500iter", "net-flagship-r4", "net-flagship-r5"]
    assert all(os.path.isfile(p) for p in shipped.values())
    assert common.network_path("net-500iter", "results/x", None) == trained.checkpoint("500iter")


def test_missing_network_raises(tmp_path):
    jax_path = elo_ladder.CHECKPOINTS["net-strong500"]
    for networks in (None, str(tmp_path)):
        with pytest.raises(FileNotFoundError, match="orbax_to_torch.py results/model_strong"):
            common.network_path("net-strong500", jax_path, networks)
    with pytest.raises(FileNotFoundError, match="copy results/parity_models/ref_seed7.pt"):
        common.network_path("ref-parity-s7", elo_ladder.PARITY["ref-parity-s7"], str(tmp_path))
    (tmp_path / "model_strong_8x8_500iter.pt").touch()
    assert common.network_path("net-strong500", jax_path, str(tmp_path)) == str(
        tmp_path / "model_strong_8x8_500iter.pt")
    with pytest.raises(FileNotFoundError, match="data/models/tpu9_flagship_r4/final_model"):
        eval_flagship.main(["--preset", "r4", "--device", "cpu"])


@pytest.mark.parametrize("main,argv", [
    (elo_ladder.main, ["--phase", "top"]),
    (standard_rules_arena.main, ["--phase", "tpu"]),
    (eval_flagship.main, ["--preset", "r5_ext", "--ckpt", "x.pt"]),
])
def test_cuda_without_a_card_raises(main, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_score_bands():
    rec = {"wins_a": 189, "wins_b": 84, "draws": 27, "n": 300}
    lo, hi = common.score_band(rec, 300)
    assert (round(lo, 3), round(hi, 3)) == (0.545, 0.793)
    for rate, inside in ((lo, True), (hi, True), (lo - 0.5 / 300, False), (hi + 0.5 / 300, False)):
        z = common.score_z({"wins_a": rate * 300, "draws": 0, "n": 300}, rec)
        assert (abs(z) <= common.Z_BAND) == inside
    assert common.score_z(rec, rec) == 0.0
    assert common.score_band({"rate": 0.5}, 300) == (122 / 300, 178 / 300)
    perfect = {"wins_a": 120, "wins_b": 0, "draws": 0, "n": 120}
    assert common.score_z(perfect, perfect) == 0.0 and common.score_band(perfect, 120)[1] == 1.0


def test_studies_import_without_jax():
    """In a fresh interpreter: every study module and what it imports load
    with jax and the JAX package blocked."""
    pkg = "othello_reinforcement_learning_test_tpu_torch.studies"
    code = "\n".join(
        ["import importlib, sys",
         *[f"sys.modules[{m!r}] = None"
           for m in ("jax", "jaxlib", "othello_reinforcement_learning_test_tpu")],
         *[f"importlib.import_module('{pkg}.{name}')" for name in MODULES],
         *[f"assert importlib.import_module('{pkg}.{name}').main" for name in MODULES[1:]],
         "print('imported', len(sys.modules))"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("imported"), out.stderr[-2000:]


def test_replay_script_holds_rows_to_records(tmp_path, monkeypatch, capsys):
    """``scripts/torch_studies_replay.py`` at a rehearsal's size: the r5_ext
    preset's two lines, each judged against its record (r5 against itself:
    the rate 0.5), written to ``replay.json``."""
    spec = importlib.util.spec_from_file_location(
        "torch_studies_replay", REPO / "scripts" / "torch_studies_replay.py")
    replay = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(replay)
    rc = replay.main(["r5_ext", "--device", "cpu", "--sims", "1", "--games", "2",
                      "--out-dir", str(tmp_path)])
    report = json.loads((tmp_path / "replay.json").read_text())
    part = report["parts"]["r5_ext"]
    assert [r["pair"] for r in part["pairs"]] == ["net-flagship-r5|net-flagship-r5",
                                                  "net-flagship-r5|net-flagship-r4"]
    ladder = trained.study_record("elo_ladder")["pairs"]["net-flagship-r5|net-flagship-r4"]
    for r, rec in zip(part["pairs"], ({"rate": 0.5}, ladder)):
        row = {"wins_a": r["row"][0], "wins_b": r["row"][1], "draws": r["row"][2], "n": 2}
        assert r["line"]["games"] == 2 == sum(r["row"][:3])
        assert r["z"] == round(common.score_z(row, rec), 3)
        assert r["in_band"] == (abs(common.score_z(row, rec)) <= common.Z_BAND)
        assert r["band"] == [round(x, 4) for x in common.score_band(rec, 2)]
    assert rc == (0 if part["ok"] else 1) and report["ok"] == part["ok"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["ok"] == part["ok"]
