"""The residual tower's share of its roofline: the least time the card's
peaks allow for the tower's work in one traced ply (each forward's
int8 multiply-adds at the int8 peak, or its bytes at the memory's, the
larger), over the device time of the tower's launches. The work is counted
from the shapes; the launches are found by the kernel names the tower's
sources define, and must number what the trunk wrapper's counter says."""

import re

from azbench.yardstick import tower_least_s

# the int8 body's convolution kernels (csrc/int8_conv_sm90.cuh), one launch a
# convolution, and the trunks' pre-pass (csrc/int8_trunk_common.cuh)
CONVS = ("int8_conv_kernel", "int8_conv_stream_kernel")
OTHERS = ("prepass_kernel",)


def _named(name, names):
    return any(re.search(rf"\b{n}\b", name) for n in names)


def read(rec):
    p, card, cfg = rec.device_pass, rec.card, rec.config
    if not p.complete or card is None:
        return None
    convs = [op for op in p.ops if _named(op.name, CONVS)]
    tower = convs + [op for op in p.ops if _named(op.name, OTHERS)]
    forwards = rec.traffic["num_simulations"] + 1
    if not convs or len(convs) != rec.trunk_launches or len(convs) != 2 * cfg["num_blocks"] * forwards:
        return None
    least, _ = tower_least_s(card, rec.traffic["games"], cfg["num_blocks"], cfg["num_filters"],
                             cfg["board_size"])
    spent = sum(op.end_ns - op.start_ns for op in tower) / 1e9
    return 100.0 * least * forwards / spent
