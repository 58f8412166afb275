"""The harness end to end on the CPU through the program's plain
versions, and the check refusing the control and every planted fault."""

import json

import pytest
import torch

from azbench import check, run
from azbench.faults import FAULTS, planted
from azbench.readings import control_forward
from azbench.reference.engine import Engine
from azbench.tests.conftest import CELLS, from_files, small


def test_dry_run_is_correct(small_cell):
    out = run.run(small_cell, 2 ** 31 + 977, 0.5, False, torch.device("cpu"), 0.0)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["metrics"]) == {"search_positions_per_s", "setup_s"}
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name
    json.dumps(out)


def _compared(cell, seed, plies, searched=None):
    """(correct, numbers, failed games) of the call at ply ``plies`` of
    ``cell``'s games; ``searched(sess)`` in place of the program's search."""
    cfg, traffic = cell.config, cell.traffic
    sess = run.prepare(cell, seed, torch.device("cpu"))
    play = sess.play
    for _ in range(plies):
        sess.ply()
    ply = play.ply((lambda: searched(sess)) if searched else None)
    kept = ply._replace(actions=play.actions[:ply.ply].clone())
    sample = check.sample_games(traffic["games"], cfg["activation_scale_block"],
                                traffic["check_blocks"], torch.Generator().manual_seed(seed))
    numbers, failed = check.compare(cfg, traffic, kept, sample, sess.sd, seed)
    return check.verdict(numbers, cfg["limits"]), numbers, int(failed.sum())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused(name):
    # the cell's own network and limits (the flagship's shipped weights, the
    # wide network's seeded 10 x 256), at a batch and depth the CPU holds
    full = from_files(name).config
    cell = small(name, blocks=full["num_blocks"], filters=full["num_filters"], sims=2, games=64,
                 seeded="file" not in full["weights"], check_blocks=1)
    correct, numbers, failed = _compared(
        cell, 11, 3, lambda sess: sess.play.search(control_forward(sess.sd, cell.config)))
    assert not correct and failed > 0
    assert numbers["prior_gap"] > cell.config["limits"]["prior_gap"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_refused_by_a_run(small_cell, fault, monkeypatch):
    # a whole run, the look for a card aside, with the fault under every call
    real = run.prepare

    def prepare(cell, seed, device):
        sess = real(cell, seed, device)
        return sess._replace(ply=planted(sess, fault))

    monkeypatch.setattr(run, "prepare", prepare)
    out = run.run(small_cell, 12, 0.3, False, torch.device("cpu"), 0.0)
    assert out["correct"] is False and out["failed"] > 0, out["checks"]


def test_roots_are_the_games_played_and_an_altered_action_is_seen():
    cell = small(CELLS[0], games=64, sims=2)
    sess = run.prepare(cell, 5, torch.device("cpu"))
    for _ in range(5):
        ply = sess.ply()
    engine = Engine(cell.config["rules"])
    actions = sess.play.actions[:ply.ply].clone()
    roots, bad = check.replay_roots(engine, actions)
    assert not bad.any()
    assert torch.equal(roots.me, ply.roots.me) and torch.equal(roots.opp, ply.roots.opp)
    actions[2, 7] = (actions[2, 7] + 1) % 65
    roots, bad = check.replay_roots(engine, actions)
    assert bool(bad[7]) or int(roots.me[7]) != int(ply.roots.me[7])


def test_same_seed_same_games():
    cell = small(CELLS[1], games=64, sims=2)

    def played(seed):
        sess = run.prepare(cell, seed, torch.device("cpu"))
        for _ in range(3):
            sess.ply()
        return sess.play.actions[:3].clone()

    a, b, c = played(3), played(3), played(4)
    assert torch.equal(a, b) and not torch.equal(a, c)


def _dirichlet(alpha, legal, gen):
    g = torch._standard_gamma(torch.full(legal.shape, alpha, dtype=torch.float64),
                              generator=gen) * legal
    return g / g.sum(dim=1, keepdim=True)


@pytest.mark.parametrize("noise,alpha", [("drawn", 0.3), ("none", 0.3), ("drawn", 3.0),
                                         ("drawn", 0.03)])
def test_noise_z_reads_the_noise(noise, alpha):
    gen = torch.Generator().manual_seed(1)
    n = 1024
    legal = torch.rand(n, 65, generator=gen) < 0.15
    legal[:, 0] = legal[:, 1] = True
    ref = _dirichlet(3.0, legal, gen)
    eta = _dirichlet(alpha, legal, gen) if noise == "drawn" else ref
    prior = torch.where(legal, 0.75 * ref + 0.25 * eta, 0.0)
    z, used = check.noise_z(prior, ref, legal, 0.3, 0.25, torch.Generator().manual_seed(2))
    assert bool(used.all())
    if noise == "drawn" and alpha == 0.3:
        assert z < 4.0
    else:
        assert z > 10.0
