"""Small cells for the benchmark's CPU tests: a cell cut to sizes the CPU
runs in seconds (the shapes only; the code paths are the card's)."""

import json

import pytest

from azbench.spec import HERE, load_cell

# the cell of BENCHMARK.json, and the flagship network on the same traffic,
# whose files the harness keeps though no cell runs it (PERF.md, Open questions)
CELLS = ("flagship_r5.selfplay", "wide_10x256.selfplay")


def from_files(name):
    """``<config>.<traffic>`` from the files under ``azbench/``, with
    ``BENCHMARK.json``'s chips and metrics."""
    config, traffic = name.split(".")
    with open(HERE / "configs" / f"{config}.json") as f:
        cfg = json.load(f)
    with open(HERE / "traffic" / f"{traffic}.json") as f:
        mix = json.load(f)
    return load_cell("wide_10x256.selfplay")._replace(name=name, config=cfg, traffic=mix)


def small(name, blocks=2, filters=16, sims=6, games=128, seeded=True, check_blocks=2):
    full = from_files(name)
    config = dict(full.config, num_blocks=blocks, num_filters=filters)
    if seeded:
        config["weights"] = {"seeded": "test"}
    traffic = dict(full.traffic, games=games, num_simulations=sims, check_blocks=check_blocks)
    return full._replace(config=config, traffic=traffic)


@pytest.fixture(params=CELLS)
def small_cell(request):
    return small(request.param)
