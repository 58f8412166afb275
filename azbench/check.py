"""The comparison that decides ``correct``.

It takes one search call of the timed window, kept whole (its roots, the
program's tree and answers, and the actions the games played before it),
and a sample of its games in whole blocks of the activation scale (the
forward quantizes each block of consecutive games with one scale, so a
block's positions are checked together). For those games it compares,
against the plain reference of :mod:`azbench.reference`:

- the games: each root, worked out again from the opening by the actions
  played, each of which has to be legal (``root_mismatches``, games);
- the engine: every position the search reached, its legal actions,
  whether it ends the game and the result (``engine_mismatches``, nodes);
- the search: each simulation's new node where the rules put it
  (``tree_mismatches``), the root's visit counts (``visit_mismatches``,
  actions) and its value and Q-values (``search_value_gap``), replayed
  from the program's evaluations (:mod:`azbench.reference.search`);
- the forward, on the very batches the search fed it: each new node's
  prior (``prior_gap``) and value (``value_gap``), the root's value (its
  result, where the root ends the game), and
  the root's noisy prior, which may not fall below ``1 - epsilon`` times
  the reference's (``root_prior_deficit``);
- the root noise: the noise the roots' priors imply, ``(prior - (1 -
  epsilon) * reference) / epsilon``, against Dirichlet(alpha) over the
  legal actions. Its squared distance from the reference's prior, summed
  over the roots with two legal actions or more, is set against the same
  sum for draws of Dirichlet(alpha) at those roots; ``noise_z`` is the
  gap in the draws' standard deviations.

Each number has its limit in the configuration's file (``limits``); a
number at or under its limit passes, one above it or not a number fails.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Tuple

import torch

from .reference.engine import Engine, Positions, initial
from .reference.network import PlainNet, masked_probs
from .reference.search import replay

NUMBERS = ("root_mismatches", "engine_mismatches", "tree_mismatches", "visit_mismatches",
           "search_value_gap", "prior_gap", "value_gap", "root_prior_deficit", "noise_z")
TREE_FIELDS = ("board_me", "board_opp", "prior", "nn_value", "children", "legal", "terminal",
               "term_value", "num_nodes")
RESULT_FIELDS = ("visit_counts", "root_value", "q_values")
CHUNK = 4096  # positions the reference's forward takes at once
NOISE_DRAWS = 256  # draws of the noise at the sampled roots, for its spread


def sample_games(games: int, block: int, blocks: int, gen: torch.Generator) -> torch.Tensor:
    """``blocks`` whole blocks of ``block`` consecutive games, drawn by ``gen``."""
    total = games // block
    chosen = torch.randperm(total, generator=gen)[:min(blocks, total)].sort().values
    return (chosen[:, None] * block + torch.arange(block)).reshape(-1)


def replay_roots(engine: Engine, actions: torch.Tensor) -> Tuple[Positions, torch.Tensor]:
    """The games' positions after ``actions`` (plies, games) from the
    opening, a game that has ended staying where it is, and per game
    whether an action of a live game was illegal."""
    pos = initial(actions.shape[1], actions.device)
    bad = torch.zeros(actions.shape[1], dtype=torch.bool, device=actions.device)
    for action in actions:
        live = ~engine.observe(pos).terminal
        nxt, ok = engine.step(pos, action)
        bad |= live & ~ok
        pos = Positions(torch.where(live, nxt.me, pos.me), torch.where(live, nxt.opp, pos.opp))
    return pos, bad


def noise_z(prior: torch.Tensor, ref: torch.Tensor, legal: torch.Tensor, alpha: float,
            eps: float, gen: torch.Generator) -> Tuple[float, torch.Tensor]:
    """(``noise_z``, the roots it reads): the noise implied at roots of two
    legal actions or more, against ``NOISE_DRAWS`` draws of Dirichlet(alpha)."""
    use = legal.sum(dim=1) >= 2
    if eps == 0 or not bool(use.any()):
        return 0.0, use
    ref, legal = ref[use], legal[use]
    implied = (prior[use].double() - (1.0 - eps) * ref) / eps
    seen = ((implied - ref) ** 2 * legal).sum()
    shape = (NOISE_DRAWS, *ref.shape)
    gamma = torch._standard_gamma(torch.full(shape, alpha, dtype=torch.float64,
                                             device=ref.device), generator=gen) * legal
    drawn = gamma / gamma.sum(dim=2, keepdim=True)
    null = ((drawn - ref) ** 2 * legal).sum(dim=(1, 2))
    return float((seen - null.mean()).abs() / null.std()), use


def compare(config: Dict, traffic: Dict, kept, games: torch.Tensor,
            sd: Dict[str, torch.Tensor], seed: int) -> Tuple[Dict[str, float], torch.Tensor]:
    """The numbers over the sampled ``games`` of the ``kept`` call
    (:class:`azbench.run.Ply`), and per game whether any of its own
    readings is over its limit. ``seed`` seeds the noise's draws."""
    tree, result, actions = kept.tree, kept.result, kept.actions
    dev = kept.roots.me.device
    games = games.to(dev)
    sims = traffic["num_simulations"]
    eps = traffic["dirichlet_epsilon"] if traffic["root_noise"] else 0.0
    shapes = {k: tuple(getattr(tree, k).shape[:2]) for k in TREE_FIELDS if k != "num_nodes"}
    if (set(shapes.values()) != {(len(kept.roots.me), sims + 1)}
            or tuple(result.visit_counts.shape) != tuple(tree.prior[:, 0].shape)):
        return {k: float("inf") for k in NUMBERS}, torch.ones(len(games), dtype=torch.bool)
    part = SimpleNamespace(**{k: getattr(tree, k)[games] for k in TREE_FIELDS})
    out = SimpleNamespace(**{k: getattr(result, k)[games] for k in RESULT_FIELDS})
    engine = Engine(config["rules"], dev)
    roots, illegal = replay_roots(engine, actions[:, games])
    root_mismatch = (illegal | (roots.me != kept.roots.me[games])
                     | (roots.opp != kept.roots.opp[games]))
    rep = replay(engine, roots, part, out, sims, traffic["c_puct"])

    net = PlainNet(sd, config["num_blocks"], 127, config["activation_scale_block"])
    fed = Positions(torch.cat([p.me for p in rep.fed]), torch.cat([p.opp for p in rep.fed]))
    seen = engine.observe(fed)
    log_p, value = net.in_chunks(seen.features, CHUNK)
    g = len(games)
    probs = masked_probs(log_p, seen.legal).reshape(sims + 1, g, -1)
    value = value.reshape(sims + 1, g)

    rows = torch.arange(g, device=dev)
    # a root that ends the game is valued by its result, as a leaf is
    root_value_gap = (part.nn_value[:, 0].double()
                      - torch.where(seen.terminal[:g], seen.winner[:g].double(), value[0])).abs()
    deficit = ((1.0 - eps) * probs[0] - part.prior[:, 0].double()).clamp_min(0).amax(dim=1)
    slot = rep.new_slot  # (sims, G)
    prior_gap = (part.prior[rows, slot].double() - probs[1:]).abs().amax(dim=2)
    prior_gap = torch.where(rep.expanded, prior_gap, 0.0).amax(dim=0)
    leaf_gap = (part.nn_value[rows, slot].double() - value[1:]).abs()
    leaf_gap = torch.where(rep.expanded & ~rep.new_terminal, leaf_gap, 0.0).amax(dim=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    z, noised = noise_z(part.prior[:, 0], probs[0], seen.legal[:g], traffic["dirichlet_alpha"],
                        eps, gen)

    per_game = {
        "root_mismatches": root_mismatch.double(),
        "engine_mismatches": rep.engine_mismatch.double(),
        "tree_mismatches": rep.tree_mismatch.double(),
        "visit_mismatches": rep.visit_mismatch.double(),
        "search_value_gap": rep.value_gap.double(),
        "prior_gap": prior_gap,
        "value_gap": torch.maximum(leaf_gap, root_value_gap),
        "root_prior_deficit": deficit,
        "noise_z": torch.where(noised, z, 0.0),
    }
    limits = config["limits"]
    summed = ("root_mismatches", "engine_mismatches", "tree_mismatches", "visit_mismatches")
    numbers = {k: float(v.sum() if k in summed else v.max()) for k, v in per_game.items()}
    numbers["noise_z"] = z
    failed = torch.zeros(g, dtype=torch.bool, device=dev)
    for k, v in per_game.items():
        failed |= ~(v <= limits[k])
    return numbers, failed


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
