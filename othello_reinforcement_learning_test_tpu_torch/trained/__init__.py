"""The repo's trained networks in the port's ``.pt`` format.

Two 10x128 JAX trainer checkpoints of ``results/`` (the flagship r5 network
and the 500-iteration one), converted on the CPU with
``scripts/orbax_to_torch.py``; ``MANIFEST.json`` gives each file's source,
step, iteration, sha256, the command that made it, and the JAX package's
recorded results for it, each with its file and key. Regenerate a file
with its ``command`` (it needs JAX and orbax, so not on the card) and put
the new sha256 into the manifest.

    MCTSPlayer.from_checkpoint(trained.checkpoint("flagship_r5"))
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

DIR = Path(__file__).resolve().parent
NAMES = ("flagship_r5", "500iter")


def manifest() -> Dict:
    with open(DIR / "MANIFEST.json") as f:
        return json.load(f)


def checkpoint(name: str) -> str:
    """The ``.pt`` path of network ``name`` (one of :data:`NAMES`)."""
    return str(DIR / manifest()["networks"][name]["file"])


def records(name: str, opponent: str) -> List[Dict]:
    """The JAX records of network ``name`` against ``opponent``."""
    return [r for r in manifest()["networks"][name]["records"] if r.get("opponent") == opponent]
