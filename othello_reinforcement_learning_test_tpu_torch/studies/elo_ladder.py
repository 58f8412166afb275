"""The Elo ladder: a round robin of the repo's networks and the classical
anchors under one protocol, and an anchored Bradley-Terry fit with
bootstrap intervals.

    python -m othello_reinforcement_learning_test_tpu_torch.studies.elo_ladder \\
        [--phase tpu|cpu|top|parity] [--fit] [--games 60] [--connect-games 24] \\
        [--out _build/studies/elo_ladder.json] [--networks DIR] [--device cpu]

Port of the JAX package's ``scripts/elo_ladder.py`` (which stays JAX-only),
with its players, pair sets, protocol (100 simulations, 4 random opening
plies, colours alternating, the seed of a pair its key's crc32) and fit.
The four ``--phase`` values are the names of its pair sets and pick no
device:

- ``tpu``: every pair of Random, Greedy and the networks of
  ``CHECKPOINTS``;
- ``cpu``: the minimax anchors against Random, Greedy and each other, then
  the network-vs-minimax connection pairs at ``--connect-games``;
- ``top``: every pair of ``TOP``;
- ``parity``: each parity seed's reference network against the repo's,
  and every parity network against Random and Greedy.

``--fit`` fits the record (:func:`bt_fit`, :func:`fit_and_report`), writes
the ratings into it and the tables beside it as ``.md``. Pairs merge into
``--out`` (default the git-ignored ``_build/studies/elo_ladder.json``; the
repo's record stays ``results/elo_ladder.json``). Networks come from
``trained/`` or ``--networks`` (``studies/common.py``); ``--device`` is
CUDA unless ``cpu`` is asked for, with no fallback.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..ops.bitboard import get_engine
from ..utils.device import resolve_device
from .common import OUT_DIR, load_results, play_pairs, write_results

CHECKPOINTS = {
    "net-500iter": "results/model_10x128_500iter",
    "net-600iter-gated": "results/model_10x128_600iter_gated",
    "net-1000iter-default": "results/model_10x128_1000iter_default",
    # round-5: the same canonical default_8x8 regime with
    # lr_schedule: constant — the reference's ACTUAL LR behavior (it never
    # steps its StepLR scheduler), isolating the schedule divergence
    "net-1000iter-default-constlr":
        "results/model_10x128_1000iter_default_constlr",
    "net-strong500": "results/model_strong_8x8_500iter",
    # round-4 flagship: the 500iter recipe scaled 2x (1000 iters x 512
    # games x 64 sims) on the round-4 stack
    "net-flagship-r4": "results/model_10x128_1000iter_flagship_r4",
    # round-5 ablation: the 500iter recipe with prioritized replay ON,
    # everything else (incl. seed) identical to net-500iter — the
    # controlled pair for VERDICT r4 item 5
    "net-500iter-prioritized": "results/model_10x128_500iter_prioritized",
    # round-5 flagship: the r4 recipe scaled to 1024 games/iteration
    # (1000 iters x 1024 games x 64 sims, buffer 800k, 24 SGD steps/iter)
    "net-flagship-r5": "results/model_10x128_1000iter_flagship_r5",
}
# matched-budget parity finals (round-3/4 parity study, 4 blocks x 32
# filters x 40 iterations): the reference's own trained checkpoints imported
# over the .pt bridge + the repo's finals exported to the same format —
# putting "repo vs reference at matched budget" on this one scale
# (VERDICT r4 item 6). Artifacts: results/parity_models/, provenance in
# results/reference_parity.md.
PARITY_SEEDS = (7, 77, 99, 2024)
PARITY = {}
for _s in PARITY_SEEDS:
    PARITY[f"ref-parity-s{_s}"] = f"results/parity_models/ref_seed{_s}.pt"
    PARITY[f"repo-parity-s{_s}"] = f"results/parity_models/repo_seed{_s}.pt"
ANCHORS = ["random", "greedy"]
# d8 added round 5 so the top of the scale is anchored, not extrapolated
# (the strongest round-4 anchor, d6, sat ~300 Elo below the ladder top)
MINIMAX = {"minimax-d2": 2, "minimax-d4": 4, "minimax-d6": 6,
           "minimax-d8": 8}
# top-subgraph replay (round 5): enough games/pair that adjacent rows
# separate at 95% or declare a tie with CI half-width <= 40
TOP = ["net-flagship-r5", "net-flagship-r4", "net-500iter",
       "net-600iter-gated"]
SIMS = 100
ELO_PER_NAT = 400.0 / 2.302585092994046  # natural rating -> Elo points
OUT = OUT_DIR / "elo_ladder.json"
BOOTSTRAPS = 200


def play_phase(pairs, games: int, out_path: str, networks: Optional[str] = None, device=None,
               sims: int = SIMS) -> Dict:
    """Play ``pairs`` under the reference rules into ``out_path``."""
    return play_pairs(pairs, games, out_path, get_engine(8, "reference"),
                      {**CHECKPOINTS, **PARITY}, MINIMAX, networks, sims, device)


def bt_fit(pairs, names, anchor="random", iters=5000, prior_draws=1.0, tol=1e-6):
    """Anchored Bradley-Terry fit on game scores (draw = 0.5); returns
    natural-log ratings with ``anchor`` pinned at 0, the name index and the
    fitted rows.

    ``prior_draws`` adds that many pseudo-draws to every observed pair
    (half a win each way): without it the likelihood has no maximum for an
    undefeated player. Zermelo/MM iteration in strength space (w = e^r),
    w_i <- S_i / sum_j n_ij / (w_i + w_j), S_i being i's total
    prior-regularized score, until max |delta log w| < ``tol``; raises if
    ``iters`` pass unconverged."""
    idx = {n: i for i, n in enumerate(names)}
    rows = []
    for key, p in pairs.items():
        a, b = key.split("|")
        if a not in idx or b not in idx:
            continue
        score_a = p["wins_a"] + 0.5 * p["draws"] + 0.5 * prior_draws
        rows.append((idx[a], idx[b], score_a, p["n"] + prior_draws))
    w = np.ones(len(names))
    score = np.zeros(len(names))
    for ia, ib, sa, n in rows:
        score[ia] += sa
        score[ib] += n - sa
    for _ in range(iters):
        denom = np.zeros(len(names))
        for ia, ib, sa, n in rows:
            d = n / (w[ia] + w[ib])
            denom[ia] += d
            denom[ib] += d
        w_new = score / np.maximum(denom, 1e-300)
        w_new /= w_new[idx[anchor]]
        delta = np.abs(np.log(w_new) - np.log(w)).max()
        w = w_new
        if delta < tol:
            break
    else:
        raise RuntimeError(
            f"bt_fit did not converge in {iters} iterations "
            f"(last max |delta log-strength| = {delta:.2e})")
    r = np.log(w)
    r -= r[idx[anchor]]
    return r, idx, rows


def fit_and_report(out_path: str, md_path: str) -> List[tuple]:
    """Fit the record at ``out_path``: 95% intervals from BOOTSTRAPS
    multinomial resamples of each pair's outcomes (``default_rng(0)``),
    adjacent rows judged on the paired bootstrap of their difference;
    writes ``ratings`` (Elo against Random, rounded to 0.1) into the record
    and the two tables to ``md_path``. Returns the rating table, best
    first."""
    results = load_results(out_path)
    names = sorted({n for key in results["pairs"] for n in key.split("|")})
    r, idx, _ = bt_fit(results["pairs"], names)

    rng = np.random.default_rng(0)
    boots = []
    for _ in range(BOOTSTRAPS):
        fake = {}
        for key, p in results["pairs"].items():
            n = p["n"]
            probs = np.array([p["wins_a"], p["draws"], p["wins_b"]], float) / n
            draw = rng.multinomial(n, probs)
            fake[key] = {"wins_a": int(draw[0]), "draws": int(draw[1]),
                         "wins_b": int(draw[2]), "n": n}
        boots.append(bt_fit(fake, names)[0])
    boots = np.array(boots)
    lo = np.percentile(boots, 2.5, axis=0)
    hi = np.percentile(boots, 97.5, axis=0)

    table = sorted(
        ((n, r[idx[n]] * ELO_PER_NAT, lo[idx[n]] * ELO_PER_NAT,
          hi[idx[n]] * ELO_PER_NAT) for n in names),
        key=lambda t: -t[1])

    # per-player intervals are correlated (each refit moves the whole
    # scale), so adjacent rows separate on the bootstrap of the difference
    sep = []
    for (na, ea, *_), (nb, eb, *_) in zip(table, table[1:]):
        d = (boots[:, idx[na]] - boots[:, idx[nb]]) * ELO_PER_NAT
        dlo, dhi = np.percentile(d, 2.5), np.percentile(d, 97.5)
        sep.append((na, nb, ea - eb, dlo, dhi,
                    "separated" if dlo > 0 else "tied"))
    results["ratings"] = {
        n: {"elo_vs_random": round(e, 1),
            "ci95": [round(a, 1), round(b, 1)]}
        for n, e, a, b in table
    }
    write_results(out_path, results)

    lines = [
        "# Elo ladder",
        "",
        "Anchored Bradley-Terry fit (Random = 0 Elo, draws scored 0.5) over",
        f"the round robin in `{Path(out_path).name}` ({SIMS} simulations for",
        "network players, 4 random opening plies, colours alternating; 95% CI",
        f"by bootstrap over game outcomes, {BOOTSTRAPS} resamples).",
        "",
        "| player | Elo (vs Random) | 95% CI |",
        "|---|---|---|",
    ]
    for n, e, a, b in table:
        lines.append(f"| {n} | {e:+.0f} | [{a:+.0f}, {b:+.0f}] |")
    lines += [
        "",
        "Adjacent-row separation (paired bootstrap of the rating",
        "difference — per-player CIs are correlated, so CI overlap is NOT",
        "the separation test):",
        "",
        "| pair | ΔElo | 95% CI of Δ | verdict |",
        "|---|---|---|---|",
    ]
    for na, nb, de, dlo, dhi, verdict in sep:
        lines.append(
            f"| {na} − {nb} | {de:+.0f} | [{dlo:+.0f}, {dhi:+.0f}] "
            f"| {verdict} |")
    lines += [
        "",
        "Fit: Zermelo/MM with a 1-pseudo-draw-per-pair prior (without it",
        "the MLE is unbounded for undefeated players; the prior shrinks",
        "all ratings slightly toward their opponents).",
        "",
    ]
    Path(md_path).write_text("\n".join(lines))
    for n, e, a, b in table:
        print(f"{n:24s} {e:+7.0f}  [{a:+.0f}, {b:+.0f}]")
    return table


def pair_sets(phase: str, games: int, connect_games: int) -> List[tuple]:
    """[(pairs, games)] that ``--phase`` plays, in order."""
    if phase == "tpu":
        fast = ANCHORS + list(CHECKPOINTS)
        return [([(a, b) for i, a in enumerate(fast) for b in fast[i + 1:]], games)]
    if phase == "top":
        return [([(a, b) for i, a in enumerate(TOP) for b in TOP[i + 1:]], games)]
    if phase == "parity":
        pairs = [(f"ref-parity-s{s}", f"repo-parity-s{s}") for s in PARITY_SEEDS]
        pairs += [(n, a) for n in PARITY for a in ANCHORS]
        return [(pairs, games)]
    mm = list(MINIMAX)
    cheap = [(a, b) for a in mm for b in ANCHORS]
    cheap += [(a, b) for i, a in enumerate(mm) for b in mm[i + 1:]]
    # network connection pairs: every checkpoint vs d4; flagships vs d2/d6/d8
    conn = [(n, "minimax-d4") for n in CHECKPOINTS]
    conn += [("net-500iter", "minimax-d2"), ("net-500iter", "minimax-d6"),
             ("net-flagship-r4", "minimax-d6"),
             ("net-flagship-r4", "minimax-d8"),
             ("net-500iter", "minimax-d8")]
    return [(cheap, games), (conn, connect_games)]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=["tpu", "cpu", "top", "parity"], default=None,
                    help="the pair set to play (a name, not a device)")
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--games", type=int, default=60)
    ap.add_argument("--connect-games", type=int, default=24,
                    help="games per network-vs-minimax pair")
    ap.add_argument("--out", default=str(OUT),
                    help="the record; the fit's tables go beside it as .md")
    ap.add_argument("--networks", default=None,
                    help="directory of .pt files for networks not shipped in trained/")
    ap.add_argument("--device", default=None, help="torch device: CUDA unless 'cpu' is asked for")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.phase:
        device = resolve_device(args.device)
        for pairs, games in pair_sets(args.phase, args.games, args.connect_games):
            play_phase(pairs, games, args.out, networks=args.networks, device=device)
    if args.fit:
        fit_and_report(args.out, str(Path(args.out).with_suffix(".md")))


if __name__ == "__main__":
    main()
