#!/usr/bin/env python
"""Replay the strength studies' recorded pairs with the port and hold each
to its JAX record.

    env PYTHONPATH=. python3 scripts/torch_studies_replay.py top [standard] [r5_ext] \\
        [--networks DIR] [--out-dir chiprun_out/studies] [--device cpu] [--sims 100] [--games N]

Imports torch, numpy and the port only, so it runs on a machine without
JAX; the records are the copies under ``..._torch/trained/records/``.
Networks not shipped in ``trained/`` (600iter-gated, sym-aug, sym-base)
come from ``--networks``, as in the study modules: ``.pt`` files made with
``scripts/orbax_to_torch.py`` into a directory inside the checkout, such
as the git-ignored ``_build/networks``.
Parts, each through the study module's own functions:

- ``top``: what ``studies.elo_ladder --phase top --games 300`` plays, the
  six pairs of ``TOP``, each against its 300-game row of
  ``results/elo_ladder.json``; also the sum of z^2 over the six, at most
  ``CHI2_6`` (chi-square, 6 degrees of freedom, 0.999);
- ``standard``: ``studies.standard_rules_arena --phase tpu --games 400``,
  ``sym-aug|sym-base`` and the four anchor pairs against their rows of
  ``results/symmetry_ablation.json``;
- ``r5_ext``: ``studies.eval_flagship --preset r5_ext --ckpt`` the shipped
  flagship r5 network: r5 against itself against the rate 0.5 (one-sample
  z), r5 against r4 against the ladder's ``net-flagship-r5|net-flagship-r4``.

A pair passes when its score rate (a draw counting half) lies in its band,
``|z| <= 3.29`` of the pooled two-proportion z against its record
(``studies/common.py::score_z``; equal rates pass). Each pair's wall
seconds stand beside the JAX record's ``wall_s``. The card's name and
power limit (``nvidia-smi``) head the output; ``<out-dir>/replay.json`` is
rewritten after every part. Exit 1 when a pair or a sum fails. ``--sims``
and ``--games`` cut a rehearsal (the bands then follow the cut games).
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

from othello_reinforcement_learning_test_tpu_torch import trained
from othello_reinforcement_learning_test_tpu_torch.studies import (
    elo_ladder,
    eval_flagship,
    standard_rules_arena,
)
from othello_reinforcement_learning_test_tpu_torch.studies.common import (
    Z_BAND,
    score,
    score_band,
    score_z,
)
from othello_reinforcement_learning_test_tpu_torch.utils.device import resolve_device

CHI2_6 = 22.46  # chi-square quantile 0.999 at 6 degrees of freedom
GAMES = {"top": 300, "standard": 400}


def nvidia_smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not available ({e.__class__.__name__})"


def judged(key: str, row: dict, record: dict, wall_s, jax_wall_s) -> dict:
    """A pair's row held to its record."""
    lo, hi = score_band(record, row["n"])
    z = score_z(row, record)
    rate = score(row) / row["n"]
    known = "rate" in record
    return {"pair": key, "row": [row["wins_a"], row["wins_b"], row["draws"], row["n"]],
            "record": (f"rate {record['rate']}" if known else
                       [record["wins_a"], record["wins_b"], record["draws"], record["n"]]),
            "rate": round(rate, 4),
            "record_rate": record["rate"] if known else round(score(record) / record["n"], 4),
            "band": [round(lo, 4), round(hi, 4)], "z": round(z, 3), "in_band": abs(z) <= Z_BAND,
            "wall_s": wall_s, "jax_wall_s": jax_wall_s}


def arena_part(module, play, phase: str, games: int, sims: int, out_dir: Path, device,
               record_name: str, networks) -> list:
    """The module's pair set played into a record of its own under
    ``out_dir``, each pair judged against the shipped record copy."""
    record = trained.study_record(record_name)["pairs"]
    out = str(out_dir / f"{record_name}.json")
    rows = []
    for pairs, n in module.pair_sets(phase, games, games):
        got = play(pairs, n, out, networks=networks, device=device, sims=sims)["pairs"]
        for a, b in pairs:
            key = f"{a}|{b}"
            rows.append(judged(key, got[key], record[key], got[key]["wall_s"],
                               record[key].get("wall_s")))
    return rows


class _Lines(io.TextIOBase):
    """stdout that notes the time each line ends, echoing it."""

    def __init__(self, echo):
        self.echo, self.buf, self.lines, self.t0 = echo, "", [], time.perf_counter()

    def write(self, s: str) -> int:
        self.echo.write(s)
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.lines.append((line, time.perf_counter()))
        return len(s)


def r5_ext_part(games: int, sims: int, device, networks) -> list:
    """The r5_ext preset with the shipped flagship r5 as ``--ckpt``."""
    ladder = trained.study_record("elo_ladder")["pairs"]
    argv = ["--preset", "r5_ext", "--ckpt", trained.checkpoint("flagship_r5"),
            "--games", str(games), "--sims", str(sims), "--device", str(device)]
    if networks:
        argv += ["--networks", networks]
    out = _Lines(sys.stdout)
    with redirect_stdout(out):
        eval_flagship.main(argv)
    records = {"net-flagship-r5": ("net-flagship-r5|net-flagship-r5", {"rate": 0.5}),
               "net-flagship-r4": ("net-flagship-r5|net-flagship-r4",
                                   ladder["net-flagship-r5|net-flagship-r4"])}
    rows, t_prev = [], out.t0
    for text, t in out.lines:
        line = json.loads(text)
        key, rec = records[line["opponent"]]
        row = {"wins_a": line["wins"], "wins_b": line["losses"], "draws": line["draws"],
               "n": line["games"]}
        rows.append({**judged(key, row, rec, round(t - t_prev, 1), rec.get("wall_s")),
                     "line": line})
        t_prev = t
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parts", nargs="+", choices=["top", "standard", "r5_ext"])
    ap.add_argument("--networks", default=None,
                    help="directory of .pt files for networks not shipped in trained/")
    ap.add_argument("--out-dir", default="chiprun_out/studies")
    ap.add_argument("--device", default=None, help="torch device: CUDA unless 'cpu' is asked for")
    ap.add_argument("--sims", type=int, default=elo_ladder.SIMS)
    ap.add_argument("--games", type=int, default=None,
                    help="games a pair (default: the records' 300, 400 and 300)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = nvidia_smi()
    print(smi, flush=True)
    report = {"nvidia_smi": smi, "device": str(device), "sims": args.sims, "parts": {}}
    ok = True
    for part in args.parts:
        t0 = time.perf_counter()
        games = args.games or GAMES.get(part, 300)
        if part == "top":
            rows = arena_part(elo_ladder, elo_ladder.play_phase, "top", games, args.sims,
                              out_dir, device, "elo_ladder", args.networks)
        elif part == "standard":
            rows = arena_part(standard_rules_arena, standard_rules_arena.play, "tpu", games,
                              args.sims, out_dir, device, "symmetry_ablation", args.networks)
        else:
            rows = r5_ext_part(games, args.sims, device, args.networks)
        entry = {"games": games, "pairs": rows, "seconds": round(time.perf_counter() - t0, 1)}
        part_ok = all(r["in_band"] for r in rows)
        if part == "top":
            entry["sum_z2"] = round(sum(r["z"] ** 2 for r in rows), 3)
            entry["sum_z2_bound"] = CHI2_6
            part_ok = part_ok and entry["sum_z2"] <= CHI2_6
        entry["ok"] = part_ok
        ok = ok and part_ok
        report["parts"][part] = entry
        report["ok"] = ok
        (out_dir / "replay.json").write_text(json.dumps(report, indent=1))
        for r in rows:
            print(json.dumps({k: r[k] for k in ("pair", "row", "record", "rate", "band", "z",
                                                 "in_band", "wall_s", "jax_wall_s")}),
                  flush=True)
        print(json.dumps({"part": part, **{k: v for k, v in entry.items() if k != "pairs"}}),
              flush=True)
    print(json.dumps({"ok": ok, "nvidia_smi": smi}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
