"""The copied operation and byte counts, and the arithmetic of the
metrics read from them."""

import pytest

from azbench import yardstick
from azbench.run import Record
from azbench.spec import reader
from azbench.tests.conftest import from_files
from azbench.trace import Op, Pass
from othello_reinforcement_learning_test_tpu_torch.utils.profiling import model_flops_per_board

CARD = yardstick.peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("blocks,filters", [(10, 128), (10, 256), (5, 64)])
def test_counts_split_the_programs_flops(blocks, filters):
    ops = 2 * (yardstick.tower_macs(blocks, filters) + yardstick.other_macs(filters))
    assert ops == model_flops_per_board(blocks, filters, 8)


def test_peaks_and_tower_bound():
    assert CARD == {"int8_ops_per_s": 1.979e15, "bf16_flops_per_s": 9.89e14,
                    "hbm_bytes_per_s": 3.35e12, "power_limit_w": 700}
    assert yardstick.peaks("some other card") is None
    # the tower at 8x8 x 256, B=1024: 0.781 ms, bound by its operations
    least, bound = yardstick.tower_least_s(CARD, 1024, 10, 256)
    assert bound == "operations" and least == pytest.approx(0.781e-3, rel=1e-3)
    # bytes: bf16 in and out, int8 weights, f32 scale and bias, each once
    assert yardstick.tower_bytes(4096, 10, 128) == (2 * 4096 * 64 * 128 * 2
                                                    + 20 * (9 * 128 * 128 + 8 * 128))


def _record(ops, calls=10, positions=9000, window_s=8.0, launches=None, host=None):
    cell = from_files("flagship_r5.selfplay")
    p = Pass(ops, (0, 1_000_000_000), True, [], {})
    n_conv = sum("int8_conv_kernel" in o.name for o in ops)
    return Record(cell.config, cell.traffic, calls, positions, window_s, CARD, p, host or p,
                  n_conv if launches is None else launches)


def test_mfu_counts_every_live_leaf_and_root():
    rec = _record([Op("k", 0, 10, 1)])
    boards = 9000 * 65
    least = boards * (2 * yardstick.tower_macs(10, 128) / 1.979e15
                      + 2 * yardstick.other_macs(128) / 9.89e14)
    assert reader("mfu.search")(rec) == pytest.approx(100 * least / 8.0)
    assert reader("mfu.search")(rec._replace(card=None)) is None


def test_roofline_takes_the_tower_launches_by_name():
    forwards = 65
    ops, t = [], 0
    for _ in range(forwards):
        ops.append(Op("void int8conv::prepass_kernel<8, 128>(bf16 const*)", t, t + 1000, 0))
        t += 2000
        for _ in range(20):
            ops.append(Op("void int8conv::(anonymous namespace)::int8_conv_kernel<8, 128, false>()",
                          t, t + 30_000, 0))
            t += 40_000
        ops.append(Op("void at::native::elementwise_kernel<>()", t, t + 5000, 0))
        t += 6000
    rec = _record(ops)
    spent = forwards * (1000 + 20 * 30_000) / 1e9
    least = yardstick.tower_least_s(CARD, 1024, 10, 128)[0] * forwards
    assert reader("trunk_roofline.search")(rec) == pytest.approx(100 * least / spent)
    # a launch count that disagrees with the wrapper's counter: nothing read
    assert reader("trunk_roofline.search")(_record(ops, launches=5)) is None
    assert reader("trunk_roofline.search")(_record(ops[:-30])) is None


def test_ops_idle_and_forward_readers():
    ops = [Op("a", 100, 300, 1), Op("b", 250, 400, 2), Op("c", 600, 700, 3)]
    p = Pass(ops, (0, 1000), True, [("search", 0, 1000), ("forward", 500, 800)],
             {1: 10, 2: 20, 3: 550})
    rec = _record([])._replace(device_pass=p, host_pass=p)
    assert reader("ops_per_sim.search")(rec) == 3 / 64
    assert reader("idle_pct.search")(rec) == pytest.approx(100 * (1 - 400 / 1000))
    assert reader("forward_ms.search")(rec) == pytest.approx(100 / 1e6)
    incomplete = p._replace(complete=False)
    for name in ("ops_per_sim.search", "idle_pct.search", "forward_ms.search"):
        assert reader(name)(rec._replace(device_pass=incomplete, host_pass=incomplete)) is None
