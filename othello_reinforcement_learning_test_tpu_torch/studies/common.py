"""What the strength studies share: players by name, the network lookup and
the pair loop with its JSON record.

The JAX scripts ``scripts/elo_ladder.py`` and ``scripts/standard_rules_arena.py``
each carry their own copy of this; here it is one module.

- A player name is ``random``, ``greedy``, a minimax anchor (a name of the
  study's ``minimax`` table: ``NativeMinimaxPlayer(depth, exact_empties=10)``)
  or a network, played by ``MCTSPlayer.from_checkpoint`` at ``sims``
  simulations through the plain bf16 eval forward, as the JAX players do.
- A network resolves first through the ``ladder_name`` of
  ``trained/MANIFEST.json`` (the shipped ``.pt`` files), then, given a
  ``--networks`` directory, as ``<dir>/<stem of its JAX path>.pt``: a file
  that ``scripts/orbax_to_torch.py`` wrote, or a reference-format ``.pt`` as
  it is (``--networks results/parity_models``). A name found in neither
  place raises, naming the command that makes the file.
- The pair loop plays ``a|b`` at ``games`` games with the seed
  ``zlib.crc32(b"a|b")``, 4 random opening plies and colours alternating,
  skips a pair whose recorded ``n`` is at least ``games``, and after each
  pair reloads the file, sets that pair's row and writes it back, so a
  pair another process wrote in between stays.

:func:`score_z` and :func:`score_band` hold a replayed pair to its record.
"""

from __future__ import annotations

import json
import math
import os
import time
import zlib
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Tuple

from .. import trained
from ..evaluation.arena import Arena
from ..evaluation.players import GreedyPlayer, MCTSPlayer, NativeMinimaxPlayer, Player, RandomPlayer
from ..ops.bitboard import OthelloEngine

SIMS = 100
OPENING_RANDOM_PLIES = 4
EXACT_EMPTIES = 10
# the JAX ladder's record header (scripts/elo_ladder.py::load_results)
PROTOCOL = {"games": "see per-pair n", "simulations": SIMS,
            "opening_random_plies": OPENING_RANDOM_PLIES, "colors": "alternate per game"}
# where a study writes unless --out says otherwise: git-ignored, never results/
OUT_DIR = Path(__file__).resolve().parents[2] / "_build" / "studies"
# |z| of the replay bands: two-sided 0.001
Z_BAND = 3.29


def shipped_networks() -> Dict[str, str]:
    """{ladder name: ``.pt`` path} of the networks under ``trained/``."""
    return {e["ladder_name"]: str(trained.DIR / e["file"])
            for e in trained.manifest()["networks"].values() if "ladder_name" in e}


def network_path(name: str, jax_path: str, networks: Optional[str] = None) -> str:
    """The ``.pt`` file of network ``name``, whose JAX checkpoint is
    ``jax_path`` (see the module docstring)."""
    shipped = shipped_networks()
    if name in shipped:
        return shipped[name]
    want = Path(networks or "<dir>") / f"{Path(jax_path).stem}.pt"
    if networks and want.is_file():
        return str(want)
    make = (f"copy {jax_path} into it" if jax_path.endswith(".pt")
            else f"python scripts/orbax_to_torch.py {jax_path} {want}")
    raise FileNotFoundError(
        f"network {name!r} is not shipped in {trained.DIR} and --networks "
        f"{'has no ' + str(want) if networks else 'was not given'}; make it with: {make}")


def make_player(name: str, engine: OthelloEngine, checkpoints: Mapping[str, str],
                minimax: Mapping[str, int], networks: Optional[str] = None, sims: int = SIMS,
                device=None) -> Player:
    """The player called ``name``; ``checkpoints`` maps a network name to its
    JAX path, ``minimax`` an anchor name to its depth."""
    if name == "random":
        return RandomPlayer(engine)
    if name == "greedy":
        return GreedyPlayer(engine)
    if name in minimax:
        return NativeMinimaxPlayer(engine, depth=minimax[name], exact_empties=EXACT_EMPTIES)
    return MCTSPlayer.from_checkpoint(network_path(name, checkpoints[name], networks),
                                      engine=engine, num_simulations=sims, device=device)


def load_results(path: str, protocol: Optional[Dict] = PROTOCOL) -> Dict:
    """The record at ``path``, or an empty one (with ``protocol`` when given)."""
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"protocol": dict(protocol), "pairs": {}} if protocol else {"pairs": {}}


def write_results(path: str, results: Dict) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


def play_pairs(pairs: Iterable[Tuple[str, str]], games: int, out_path: str, engine: OthelloEngine,
               checkpoints: Mapping[str, str], minimax: Mapping[str, int],
               networks: Optional[str] = None, sims: int = SIMS, device=None,
               protocol: Optional[Dict] = PROTOCOL) -> Dict:
    """Play each pair not yet recorded at ``games`` games into ``out_path``
    (see the module docstring); returns the record as last written."""
    arena = Arena(engine, device=device)
    results = load_results(out_path, protocol)
    players: Dict[str, Player] = {}

    def get(name: str) -> Player:
        if name not in players:
            players[name] = make_player(name, engine, checkpoints, minimax, networks, sims,
                                        device)
        return players[name]

    for a, b in pairs:
        key = f"{a}|{b}"
        if results["pairs"].get(key, {}).get("n", 0) >= games:
            print(f"{key}: cached", flush=True)
            continue
        t0 = time.time()
        s = arena.play_matches(get(a), get(b), games, zlib.crc32(key.encode()),
                               opening_random_plies=OPENING_RANDOM_PLIES)
        row = {"wins_a": s.wins, "wins_b": s.losses, "draws": s.draws, "n": games,
               "wall_s": round(time.time() - t0, 1)}
        print(f"{key}: {s.wins}W-{s.losses}L-{s.draws}D [{row['wall_s']}s]", flush=True)
        results = load_results(out_path, protocol)
        results["pairs"][key] = row
        write_results(out_path, results)
    return results


def score(row: Mapping) -> float:
    """Side a's score in a pair row, a draw counting half."""
    return row["wins_a"] + 0.5 * row["draws"]


def score_z(row: Mapping, record: Mapping) -> float:
    """The pooled two-proportion z of ``row``'s score rate against
    ``record``'s (rows as the pair loop writes them); against a known rate,
    ``{"rate": p}`` (a network against itself: 0.5), the one-sample z. 0
    when the two rates are equal."""
    n1 = row["n"]
    p1 = score(row) / n1
    if "rate" in record:
        p = record["rate"]
        return 0.0 if p1 == p else (p1 - p) / math.sqrt(p * (1 - p) / n1)
    n2 = record["n"]
    p2 = score(record) / n2
    if p1 == p2:
        return 0.0
    p = (score(row) + score(record)) / (n1 + n2)
    return (p1 - p2) / math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))


def score_band(record: Mapping, n: int, z: float = Z_BAND) -> Tuple[float, float]:
    """The lowest and highest score rate of an ``n``-game row (scores in
    half points) with ``|score_z| <= z`` against ``record``."""
    ok = [k / 2 for k in range(2 * n + 1)
          if abs(score_z({"wins_a": k / 2, "draws": 0, "n": n}, record)) <= z]
    return ok[0] / n, ok[-1] / n
