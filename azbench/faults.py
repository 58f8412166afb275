"""Faults planted under a search call, each of which the check has to
refuse: the readings that set the limits' upper ends, and the fault test.

Each fault is ``fault(call, games, sims) -> (result, tree)`` around
``call(net_wrap=None, eng_wrap=None, sims=None, half=False, noise=None)``,
one call of the program's search with its tree kept (``net_wrap`` and
``eng_wrap`` wrap the program's forward and engine, ``sims`` replaces the
simulations, ``half`` searches the first half of the games and leaves the
rest zero, ``noise`` turns the root noise on or off). Each alters what the
timed path produces where it is produced, for every game, so that any
sample of games sees it.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict

import torch


def engine_step_altered(call: Callable, games: int, sims: int):
    """The engine's step toggles a stone on square a1 of every game's new
    position, in one simulation."""
    seen = []

    def wrap(engine):
        class Faulty:
            def __getattr__(self, name):
                return getattr(engine, name)

            def step(self, *a, **k):
                child, ok = engine.step(*a, **k)
                seen.append(1)
                if len(seen) == 3:
                    child = child._replace(me=child.me ^ 1)
                return child, ok
        return Faulty()
    return call(eng_wrap=wrap)


def forward_altered(call: Callable, games: int, sims: int):
    """One forward returns a value 0.5 off for every game of its batch."""
    seen = []

    def wrap(net):
        def faulty(x):
            log_p, v = net(x)
            seen.append(1)
            return (log_p, v + 0.5) if len(seen) == 4 else (log_p, v)
        return faulty
    return call(net_wrap=wrap)


def answer_altered(call: Callable, games: int, sims: int):
    """The result moves one visit of every game from its best action to the
    next legal one."""
    result, tree = call()
    counts = result.visit_counts.clone()
    best = counts.argmax(dim=1)
    rows = torch.arange(games, device=counts.device)
    other = torch.where(result.legal, 1.0, 0.0)
    other[rows, best] = 0.0
    alt = other.argmax(dim=1)
    counts[rows, best] -= 1.0
    counts[rows, alt] += 1.0
    return result._replace(visit_counts=counts), tree


def half_batch(call: Callable, games: int, sims: int):
    """Half of the games are searched; the other half's answers and tree
    stay zero."""
    result, tree = call(half=True)

    def pad(t):
        return torch.cat([t, torch.zeros((games - t.shape[0], *t.shape[1:]), dtype=t.dtype,
                                         device=t.device)])
    return (result._replace(**{k: pad(v) for k, v in result._asdict().items()}),
            SimpleNamespace(**{k: pad(v) for k, v in vars(tree).items()}))


def state_unchanged(call: Callable, games: int, sims: int):
    """The search stops halfway: the later simulations leave the tree and
    the answers as they were."""
    result, tree = call(sims=sims // 2)

    def pad(t):
        if t.dim() < 2:
            return t
        return torch.cat([t, torch.zeros((t.shape[0], sims - sims // 2, *t.shape[2:]),
                                         dtype=t.dtype, device=t.device)], dim=1)
    return result, SimpleNamespace(**{k: pad(v) for k, v in vars(tree).items()})


def root_noise_left_out(call: Callable, games: int, sims: int):
    """The roots' priors are searched without their Dirichlet noise."""
    return call(noise=False)


FAULTS: Dict[str, Callable] = {f.__name__: f for f in (
    engine_step_altered, forward_altered, answer_altered, half_batch, state_unchanged,
    root_noise_left_out)}


def planted(sess, name: str) -> Callable:
    """``sess.ply`` (:func:`azbench.run.prepare`) with fault ``name``
    planted under every call of the search."""
    play = sess.play
    games, sims = play.games, play.traffic["num_simulations"]

    def one(net_wrap=None, eng_wrap=None, sims=None, half=False, noise=None):
        return play.search(net_wrap(play.forward) if net_wrap else None,
                           eng_wrap(play.engine) if eng_wrap else None, sims, half, noise)
    return lambda: play.ply(lambda: FAULTS[name](one, games, sims))
