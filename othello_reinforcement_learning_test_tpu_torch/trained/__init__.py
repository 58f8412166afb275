"""The repo's trained networks in the port's ``.pt`` format.

Three 10x128 JAX trainer checkpoints of ``results/``, converted on the CPU
with ``scripts/orbax_to_torch.py``: the flagship r5 network and the
500-iteration one (:data:`NAMES`, whose every trunk ``chip_smoke.py`` and
the trained tests check), and flagship r4 for the strength studies
(:data:`STUDY_NAMES`). Each is the network its ``ladder_name`` names in
the studies; the studies read other networks from a ``--networks``
directory. ``MANIFEST.json`` gives each file's source,
step, iteration, sha256, the command that made it, and the JAX package's
recorded results for it, each with its file and key. Regenerate a file
with its ``command`` (it needs JAX and orbax, so not on the card) and put
the new sha256 into the manifest.

``records/`` holds copies of the two JAX records the studies replay on the
card, which has no ``results/``: ``elo_ladder.json`` and
``symmetry_ablation.json`` (:func:`study_record`).

    MCTSPlayer.from_checkpoint(trained.checkpoint("flagship_r5"))
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

DIR = Path(__file__).resolve().parent
NAMES = ("flagship_r5", "500iter")
STUDY_NAMES = ("flagship_r4",)


def manifest() -> Dict:
    with open(DIR / "MANIFEST.json") as f:
        return json.load(f)


def checkpoint(name: str) -> str:
    """The ``.pt`` path of network ``name`` (one of :data:`NAMES` or
    :data:`STUDY_NAMES`)."""
    return str(DIR / manifest()["networks"][name]["file"])


def records(name: str, opponent: str) -> List[Dict]:
    """The JAX records of network ``name`` against ``opponent``."""
    return [r for r in manifest()["networks"][name]["records"] if r.get("opponent") == opponent]


def study_record(name: str) -> Dict:
    """The copy of the JAX record ``results/<name>.json`` under ``records/``."""
    with open(DIR / "records" / f"{name}.json") as f:
        return json.load(f)
