#!/usr/bin/env python3
"""Train the shipped ``default_8x8`` config through the port's ``cli train``
with a resume halfway, play its learning curve, and hold both to the JAX
package's two recorded runs of that config.

    PYTHONPATH=. python3 scripts/torch_learning_run.py
    PYTHONPATH=. python3 scripts/torch_learning_run.py --config configs/test.yaml \\
        --iterations 3 --resume-at 2 --anchor-iteration 1 --games 2 --simulations 2 --device cpu

Steps, each through a user's entry point and in one process:

1. ``--config`` read with the port's ``load_config``; only
   ``training.num_iterations`` (``--resume-at``), the three ``paths`` (into
   ``--workdir``) and, with ``--device cpu``, ``system.device`` change. The
   cut is written with ``to_yaml`` and read back;
2. ``cli train --config <cut>``: iterations 1 to ``--resume-at``;
3. the file raised to ``--iterations`` and ``cli train --config <cut>
   --resume latest``: it must resume from ``final_model`` at
   ``--resume-at`` and run the iterations after it, each once;
4. the port's ``learning_curve`` on a directory that holds only
   ``checkpoint_iter_<iterations>.pt``, with
   ``checkpoint_iter_<anchor-iteration>.pt`` as its anchor, ``--games``,
   ``--simulations``, ``--opening-random-plies`` and seed 42 (the protocol
   of the JAX curve, ``results/learning_curve_tpu5_1000iter.json``);
   each match's wins, losses and draws are taken from the evaluation calls
   it makes.

``--out`` (JSON) is rewritten after every iteration and every step, so a
run that is cut short still leaves its figures: each iteration's loss,
self-play, SGD and checkpoint seconds and buffer size (parsed from the
trainer's lines); the means of five iterations beside the JAX runs'; the
three matches with Wilson 95% intervals; the ``nvidia-smi`` name and power
limit.

The bars apply to ``configs/default_8x8.yaml`` at 50 iterations and 64
games a match only; the script exits 1 when one fails:

- loss: the mean of iterations 21-25 in [4.36, 4.86] and of 46-50 in
  [3.81, 4.32] (the two JAX runs' means, 4.608 and 4.063, +- 0.25);
- learning: the iteration-50 network wins at least 38 of 64 against the
  iteration-10 network;
- strength: at least 33 of 64 against Random and against Greedy (the
  JAX runs' first strength record is at iteration 100, printed beside the
  result for context).

Imports torch, numpy and the port only: no JAX, no pyyaml. ``--device
auto`` is the card (CUDA is required); ``cpu`` the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))  # the repository's packages

from othello_reinforcement_learning_test_tpu_torch import cli, learning_curve  # noqa: E402
from othello_reinforcement_learning_test_tpu_torch.utils.config import (  # noqa: E402
    load_config,
    to_yaml,
)

# the JAX package's two runs of configs/default_8x8.yaml on a TPU: the mean
# loss of the five iterations ending at each key, from the first
# "iter i/N loss=" line of each iteration in the log
JAX_RUNS = {
    "results/train_tpu5_default8x8_1000iter.log":
        {5: 5.094, 10: 4.838, 25: 4.596, 40: 4.273, 50: 4.054, 100: 3.107},
    "results/train_tpu10_default_constlr.log":
        {5: 5.086, 10: 4.851, 25: 4.619, 40: 4.261, 50: 4.071, 100: 3.125},
}
# the first strength record of the first run: iteration 100, 64 games at 100
# simulations and 4 random opening plies: (wins, games)
JAX_CURVE = {"file": "results/learning_curve_tpu5_1000iter.json", "iteration": 100,
             "games": 64, "simulations": 100, "opening_random_plies": 4,
             "Random": (55, 64), "Greedy": (57, 64)}
BARS_CONFIG = REPO / "configs" / "default_8x8.yaml"
BARS_ITERATIONS, BARS_GAMES = 50, 64
LOSS_BARS = {25: (4.36, 4.86), 50: (3.81, 4.32)}
ANCHOR_WINS, BASELINE_WINS = 38, 33
CURVE_SEED = 42
Z95 = 1.959963984540054
ITER_LINE = re.compile(r"iter (\d+)/(\d+) loss=(\S+?)(?: [↓↑])? self_play=([0-9.]+)s "
                       r"train=([0-9.]+)s buffer=(\d+)")
CHECKPOINT_LINE = re.compile(r"checkpoint checkpoint_iter_(\d+) written in ([0-9.]+)s")
RESUME_LINE = re.compile(r"resumed from (\S+) at iteration (\d+)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="configs/default_8x8.yaml")
    parser.add_argument("--iterations", type=int, default=50)
    parser.add_argument("--resume-at", type=int, default=25)
    parser.add_argument("--anchor-iteration", type=int, default=10)
    parser.add_argument("--games", type=int, default=64)
    parser.add_argument("--simulations", type=int, default=100)
    parser.add_argument("--opening-random-plies", type=int, default=4)
    parser.add_argument("--workdir", default=str(REPO / "_build" / "learning_run"),
                        help="the run's config, checkpoints and logs (emptied first)")
    parser.add_argument("--out", default=str(REPO / "chiprun_out" / "learning_run.json"))
    parser.add_argument("--device", choices=["auto", "cpu"], default="auto",
                        help="auto = CUDA (required); cpu = the CPU")
    return parser


def wilson(wins: int, games: int) -> List[float]:
    """The Wilson score 95% interval of a win rate."""
    if games == 0:
        return [0.0, 1.0]
    p, z2 = wins / games, Z95 ** 2
    centre = (p + z2 / (2 * games)) / (1 + z2 / games)
    half = Z95 * math.sqrt(p * (1 - p) / games + z2 / (4 * games ** 2)) / (1 + z2 / games)
    return [centre - half, centre + half]


def nvidia_smi() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, None without one."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def loss_means(iterations: List[Dict]) -> Dict[int, float]:
    """{last iteration of a JAX window: the mean loss of its five
    iterations}, for the windows the run reached."""
    loss = {row["iteration"]: row["loss"] for row in iterations}
    return {end: sum(loss[i] for i in range(end - 4, end + 1)) / 5
            for end in next(iter(JAX_RUNS.values())) if all(i in loss for i in range(end - 4, end + 1))}


class Tee:
    """A stdout that passes text on and calls ``on_line`` with every whole
    line."""

    def __init__(self, stream, on_line):
        self.stream, self.on_line, self.partial, self.text = stream, on_line, "", []

    def write(self, s: str) -> int:
        self.stream.write(s)
        self.text.append(s)
        lines = (self.partial + s).split("\n")
        self.partial = lines.pop()
        for line in lines:
            self.on_line(line)
        return len(s)

    def flush(self) -> None:
        self.stream.flush()


class Record:
    """The run's figures, written to ``path`` whenever they change."""

    def __init__(self, path: str, fields: Dict):
        self.path, self.data = path, {**fields, "iterations_log": [], "steps": {}}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.write()

    def write(self) -> None:
        self.data["loss_means"] = {f"{end - 4}-{end}": m
                                   for end, m in loss_means(self.data["iterations_log"]).items()}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.data, f, indent=1)
        os.replace(tmp, self.path)

    def on_line(self, line: str) -> None:
        m = ITER_LINE.search(line)
        if m:
            self.data["iterations_log"].append({
                "iteration": int(m.group(1)), "of": int(m.group(2)), "loss": float(m.group(3)),
                "self_play_s": float(m.group(4)), "train_s": float(m.group(5)),
                "buffer": int(m.group(6))})
            self.write()
        m = CHECKPOINT_LINE.search(line)
        if m:
            for row in self.data["iterations_log"]:
                if row["iteration"] == int(m.group(1)):
                    row["checkpoint_s"] = float(m.group(2))
            self.write()


def train(record: Record, argv: Sequence[str]) -> str:
    """``cli train`` in this process, its lines parsed as they come; returns
    its output."""
    tee = Tee(sys.stdout, record.on_line)
    with contextlib.redirect_stdout(tee):
        cli.main(list(argv))
    return "".join(tee.text)


@contextlib.contextmanager
def recording_matches(into: List[Dict]):
    """Each of ``learning_curve``'s evaluation calls with its result."""
    evaluate = learning_curve.evaluate_player

    def recorded(player, opponent, *a, **kw):
        out = evaluate(player, opponent, *a, **kw)
        into.append(out)
        return out

    learning_curve.evaluate_player = recorded
    try:
        yield
    finally:
        learning_curve.evaluate_player = evaluate


def check_sequence(log: List[Dict], first: int, last: int, of: int, what: str) -> None:
    got = [(r["iteration"], r["of"]) for r in log]
    want = [(i, of) for i in range(first, last + 1)]
    if got != want:
        raise SystemExit(f"{what}: the iterations ran {got}, not {first}-{last} of {of} once each")


def bars(data: Dict) -> Dict:
    """Each bar with its figure and whether it holds."""
    means = loss_means(data["iterations_log"])
    out = {}
    for end, (lo, hi) in LOSS_BARS.items():
        out[f"loss_{end - 4}-{end}"] = {"value": means.get(end), "range": [lo, hi],
                                        "ok": means.get(end) is not None
                                        and lo <= means[end] <= hi}
    matches = data["matches"]
    out["vs_anchor"] = {"wins": matches["Anchor"]["wins"], "at_least": ANCHOR_WINS,
                        "ok": matches["Anchor"]["wins"] >= ANCHOR_WINS}
    for name in ("Random", "Greedy"):
        out[f"vs_{name.lower()}"] = {"wins": matches[name]["wins"], "at_least": BASELINE_WINS,
                                     "ok": matches[name]["wins"] >= BASELINE_WINS}
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not 0 < args.anchor_iteration <= args.resume_at < args.iterations:
        raise SystemExit("need 0 < --anchor-iteration <= --resume-at < --iterations")
    t_start = time.perf_counter()
    work = Path(args.workdir).resolve()
    shutil.rmtree(work, ignore_errors=True)
    (work / "curve").mkdir(parents=True)
    cfg = load_config(args.config)
    cfg["training"]["num_iterations"] = args.resume_at
    cfg["paths"] = {"checkpoint_dir": str(work / "models"), "log_dir": str(work / "logs"),
                    "data_dir": str(work)}
    if args.device == "cpu":
        cfg["system"]["device"] = "cpu"
    cut = work / "config.yaml"
    cut.write_text(to_yaml(cfg))
    if load_config(str(cut)) != cfg:
        raise SystemExit(f"{cut} does not read back equal")
    applied = (Path(args.config).resolve() == BARS_CONFIG and args.iterations == BARS_ITERATIONS
               and args.games == BARS_GAMES)
    record = Record(args.out, {
        "config": args.config, "iterations": args.iterations, "resume_at": args.resume_at,
        "anchor_iteration": args.anchor_iteration, "games": args.games,
        "simulations": args.simulations, "opening_random_plies": args.opening_random_plies,
        "curve_seed": CURVE_SEED, "device": args.device, "nvidia_smi": nvidia_smi(),
        "jax_runs": {f: {f"{e - 4}-{e}": v for e, v in m.items()} for f, m in JAX_RUNS.items()},
        "jax_curve": {**JAX_CURVE, **{n: {"wins": JAX_CURVE[n][0], "games": JAX_CURVE[n][1],
                                          "wilson95": wilson(*JAX_CURVE[n])}
                                      for n in ("Random", "Greedy")}},
        "bars_applied": applied})
    log = record.data["iterations_log"]

    t0 = time.perf_counter()
    train(record, ["train", "--config", str(cut)])
    record.data["steps"]["train_s"] = time.perf_counter() - t0
    check_sequence(log, 1, args.resume_at, args.resume_at, "the first run")
    record.write()

    cfg["training"]["num_iterations"] = args.iterations
    cut.write_text(to_yaml(cfg))
    t0 = time.perf_counter()
    out = train(record, ["train", "--config", str(cut), "--resume", "latest"])
    record.data["steps"]["resume_s"] = time.perf_counter() - t0
    m = RESUME_LINE.search(out)
    final = str(work / "models" / "final_model.pt")
    if m is None or m.group(1) != final or int(m.group(2)) != args.resume_at:
        raise SystemExit(f"the second run did not resume from {final} at iteration "
                         f"{args.resume_at}: {m.group(0) if m else 'no resume line'}")
    record.data["resumed_from"] = m.group(0)
    check_sequence(log[args.resume_at:], args.resume_at + 1, args.iterations, args.iterations,
                   "the resumed run")
    record.write()

    models = work / "models"
    player, anchor = (models / f"checkpoint_iter_{i:06d}.pt"
                      for i in (args.iterations, args.anchor_iteration))
    for path in (player, anchor):
        if not path.is_file():
            raise SystemExit(f"{path} was not written (checkpoint_interval)")
    for suffix in ("", ".config.json", ".meta.json"):
        if Path(str(player) + suffix).exists():
            os.symlink(str(player) + suffix, work / "curve" / (player.name + suffix))
    matches: List[Dict] = []
    t0 = time.perf_counter()
    with recording_matches(matches):
        learning_curve.main([
            "--checkpoint-dir", str(work / "curve"), "--anchor-checkpoint", str(anchor),
            "--games", str(args.games), "--simulations", str(args.simulations),
            "--opening-random-plies", str(args.opening_random_plies),
            "--seed", str(CURVE_SEED), "--device", args.device,
            "--output", str(work / "curve.json")])
    record.data["steps"]["curve_s"] = time.perf_counter() - t0
    with open(work / "curve.json") as f:
        record.data["curve"] = json.load(f)["curve"]
    record.data["matches"] = {
        m["opponent"]: {k: m[k] for k in ("wins", "losses", "draws", "win_rate", "avg_score")}
        | {"wilson95": wilson(m["wins"], m["num_games"])} for m in matches}
    record.write()
    record.data["bars"] = bars(record.data) if applied else None
    record.data["steps"]["total_s"] = time.perf_counter() - t_start
    ok = not applied or all(b["ok"] for b in record.data["bars"].values())
    record.data["ok"] = ok
    record.write()

    print(f"loss means (port | {' | '.join(JAX_RUNS)}):")
    for end, mean in loss_means(log).items():
        print(f"  {end - 4:>3}-{end:<3} {mean:.3f} | "
              + " | ".join(f"{m[end]:.3f}" for m in JAX_RUNS.values()))
    for name, r in record.data["matches"].items():
        lo, hi = r["wilson95"]
        jax = JAX_CURVE.get(name)
        context = (f"  (JAX iteration {JAX_CURVE['iteration']}: {jax[0]}/{jax[1]})"
                   if jax else "")
        print(f"  iteration {args.iterations} vs {name}: {r['wins']}W-{r['losses']}L-"
              f"{r['draws']}D, Wilson 95% [{lo:.3f}, {hi:.3f}]{context}")
    if applied:
        for name, b in record.data["bars"].items():
            print(f"  bar {name}: {'ok' if b['ok'] else 'FAILED'} {b}")
    print(f"figures in {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
