"""What the benchmark measures against: the work a forward needs, counted
from the configuration's shapes, and the card's published peaks.

The counts split the dual-head ResNet into the tower, which the
configuration runs in int8, and the stem and heads, which it runs in
bf16. An operation is a multiply or an add, so a multiply-add counts two.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def tower_macs(blocks: int, filters: int, side: int = 8) -> int:
    """Multiply-adds of the residual tower for one board: 2 x ``blocks``
    3x3 convolutions of ``filters`` channels in and out."""
    return 2 * blocks * side * side * 9 * filters * filters


def other_macs(filters: int, side: int = 8, hidden: int = 256) -> int:
    """Multiply-adds of the stem and both heads for one board."""
    ss = side * side
    stem = ss * 9 * 3 * filters
    policy = ss * filters * 2 + 2 * ss * (ss + 1)
    value = ss * filters + ss * hidden + hidden
    return stem + policy + value


def tower_bytes(games: int, blocks: int, filters: int, side: int = 8) -> int:
    """Bytes the tower must move for one forward of ``games`` boards, each
    once: the bf16 input and output activations, the int8 weights, and the
    f32 scale and bias of each convolution."""
    convs = 2 * blocks
    activations = 2 * games * side * side * filters * 2
    return activations + convs * (9 * filters * filters + 2 * 4 * filters)


def peaks(device_name: str) -> Optional[Dict]:
    """The published peaks of the card that calls itself ``device_name``,
    or None for a card the table does not hold."""
    with open(PEAKS_FILE) as f:
        return json.load(f)["cards"].get(device_name)


def forward_least_s(card: Dict, blocks: int, filters: int, side: int = 8,
                    hidden: int = 256) -> float:
    """The least time one board's forward takes at the card's peaks: the
    tower at the int8 rate, the stem and heads at the bf16 rate."""
    return (2 * tower_macs(blocks, filters, side) / card["int8_ops_per_s"]
            + 2 * other_macs(filters, side, hidden) / card["bf16_flops_per_s"])


def tower_least_s(card: Dict, games: int, blocks: int, filters: int, side: int = 8):
    """(least seconds, the bound that sets it) of one tower forward of
    ``games`` boards: operations at the int8 peak or bytes at the memory's."""
    ops = 2 * games * tower_macs(blocks, filters, side) / card["int8_ops_per_s"]
    moved = tower_bytes(games, blocks, filters, side) / card["hbm_bytes_per_s"]
    return (ops, "operations") if ops >= moved else (moved, "bytes")
