"""Plain MCTS, replayed beside a tree the program's search built.

The search the configuration states: PUCT with ``c_puct`` (a parent takes
the legal action that maximizes ``Q + c_puct * P * sqrt(N(parent)) /
(1 + N(edge))``, ``Q`` the negated mean value of the child, 0 unvisited,
ties to the lowest action), one leaf expanded per simulation, terminal
leaves valued by the game's result, values backed up with alternating
signs, and the root counted as visited once before the first simulation.
Statistics are float32, as the configuration keeps them, so that every
sum is taken in the same order and the replay's counts and values are the
program's exactly when the program is right.

The replay cannot draw the program's root noise again, and the
network's values depend on float rounding, so it follows the program's
own evaluations: the root's noisy prior and value, and each new node's
prior and value, read from the program's tree at the slot the replay
expects the node in. Everything else it works out itself: which edge
each simulation expands (and whether the program's tree has the node
there), each position reached (:mod:`.engine`), which leaves are
terminal and their results, the backup, and the root's visit counts,
value and Q-values. The evaluations it takes are checked apart, against
:mod:`.network`, by :mod:`azbench.check`.

The program's tree is read through attributes ``board_me``,
``board_opp``, ``prior``, ``nn_value``, ``children``, ``legal``,
``terminal``, ``term_value`` and ``num_nodes`` (games, slots, ...), its
result through ``visit_counts``, ``root_value`` and ``q_values``.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from .engine import Engine, Positions

f32, f64 = torch.float32, torch.float64


class Replay(NamedTuple):
    """Per game (G,) unless said: what differs from the program, and the
    positions each forward of the search was given."""

    engine_mismatch: torch.Tensor  # nodes whose position, legal actions, end or result differ
    tree_mismatch: torch.Tensor  # simulations whose new node is not where the rules put it
    visit_mismatch: torch.Tensor  # root actions whose visit count differs
    value_gap: torch.Tensor  # largest gap of the root value and the Q-values (f32)
    fed: List[Positions]  # (sims + 1) x (G,): the positions each forward saw
    expanded: torch.Tensor  # (sims, G) bool: the simulation added a node
    new_slot: torch.Tensor  # (sims, G): the slot of the node it added
    new_terminal: torch.Tensor  # (sims, G) bool: that node ends the game


def puct_action(visits, edge_visits, edge_values, prior, legal, c_puct: float):
    """The action PUCT takes at one node of each game (all float32)."""
    q = torch.where(edge_visits > 0, -edge_values / edge_visits.clamp_min(1), 0.0)
    root = torch.sqrt(visits.clamp_min(1).to(f64)).to(f32)
    u = c_puct * prior * root[:, None] / (1.0 + edge_visits.to(f32))
    return torch.argmax(torch.where(legal, q + u, -torch.inf), dim=1)


def replay(engine: Engine, roots: Positions, tree, result, sims: int,
           c_puct: float) -> Replay:
    """Replay ``sims`` simulations of each game from ``roots`` beside the
    program's ``tree`` and compare with its ``result``."""
    G, A = tree.prior.shape[0], tree.prior.shape[2]
    dev = roots.me.device
    rows = torch.arange(G, device=dev)
    n = sims + 1

    def slots(*shape, dtype, fill=0):
        return torch.full((G, n, *shape), fill, dtype=dtype, device=dev)

    me, opp = slots(dtype=torch.int64), slots(dtype=torch.int64)
    legal, terminal = slots(A, dtype=torch.bool), slots(dtype=torch.bool)
    result_of = slots(dtype=f32)
    prior = slots(A, dtype=f32)
    visits, values = slots(dtype=torch.int32), slots(dtype=f32)
    child = slots(A, dtype=torch.int64, fill=-1)
    edge_visits, edge_values = slots(A, dtype=torch.int32), slots(A, dtype=f32)
    count = torch.ones(G, dtype=torch.int64, device=dev)

    ob = engine.observe(roots)
    me[:, 0], opp[:, 0] = roots.me, roots.opp
    legal[:, 0], terminal[:, 0], result_of[:, 0] = ob.legal, ob.terminal, ob.winner.to(f32)
    engine_mismatch = ((tree.board_me[:, 0] != roots.me) | (tree.board_opp[:, 0] != roots.opp)
                       | (tree.legal[:, 0] != ob.legal).any(dim=1)
                       | (tree.terminal[:, 0] != ob.terminal)
                       | (tree.term_value[:, 0] != result_of[:, 0])).to(torch.int64)
    tree_mismatch = torch.zeros(G, dtype=torch.int64, device=dev)
    prior[:, 0] = tree.prior[:, 0]
    visits[:, 0] = 1
    values[:, 0] = tree.nn_value[:, 0]

    fed, expanded, new_slot, new_terminal = [roots], [], [], []
    for _ in range(sims):
        # the walk: down expanded edges until an unexpanded one or a game's end;
        # path[:, d] is the node at depth d, took[:, d] the action taken from it
        path = torch.full((G, n + 1), -1, dtype=torch.int64, device=dev)
        took = torch.full((G, n + 1), -1, dtype=torch.int64, device=dev)
        path[:, 0] = 0
        node = torch.zeros(G, dtype=torch.int64, device=dev)
        depth = torch.zeros(G, dtype=torch.int64, device=dev)
        walking = ~terminal[:, 0]
        at_end = terminal[:, 0].clone()
        action = torch.zeros(G, dtype=torch.int64, device=dev)
        while bool(walking.any()):
            a = puct_action(visits[rows, node], edge_visits[rows, node],
                            edge_values[rows, node], prior[rows, node], legal[rows, node],
                            c_puct)
            nxt = child[rows, node, a]
            descend = walking & (nxt >= 0)
            action = torch.where(walking & ~descend, a, action)
            took[rows, depth] = torch.where(descend, a, took[rows, depth])
            depth = depth + descend.to(torch.int64)
            node = torch.where(descend, nxt, node)
            path[rows, depth] = torch.where(descend, node, path[rows, depth])
            ends = descend & terminal[rows, node]
            at_end |= ends
            walking = descend & ~ends
        grow = ~at_end
        parent = node
        reached, _ = engine.step(Positions(me[rows, parent], opp[rows, parent]),
                                 torch.where(grow, action, 0))
        seen = engine.observe(reached)
        new = count.clone()
        tree_mismatch += (grow & (tree.children[rows, parent, action] != new)).to(torch.int64)
        engine_mismatch += (grow & ((tree.board_me[rows, new] != reached.me)
                                    | (tree.board_opp[rows, new] != reached.opp)
                                    | (tree.legal[rows, new] != seen.legal).any(dim=1)
                                    | (tree.terminal[rows, new] != seen.terminal)
                                    | (tree.term_value[rows, new] != seen.winner.to(f32))
                                    )).to(torch.int64)
        for arr, val in ((me, reached.me), (opp, reached.opp), (legal, seen.legal),
                         (terminal, seen.terminal), (result_of, seen.winner.to(f32)),
                         (prior, tree.prior[rows, new])):
            old = arr[rows, new]
            arr[rows, new] = torch.where(grow.view(-1, *[1] * (old.dim() - 1)), val, old)
        child[rows, parent, action] = torch.where(grow, new, child[rows, parent, action])
        count += grow.to(torch.int64)
        leaf = torch.where(grow, torch.where(seen.terminal, seen.winner.to(f32),
                                             tree.nn_value[rows, new]),
                           result_of[rows, node])

        # the backup, the new node last on the path where one was added
        took[rows, depth] = torch.where(grow, action, took[rows, depth])
        leaf_depth = depth + grow.to(torch.int64)
        path[rows, leaf_depth] = torch.where(grow, new, path[rows, leaf_depth])
        for d in range(int(leaf_depth.max()) + 1):
            on = d <= leaf_depth
            slot = path[:, d].clamp_min(0)
            sign = torch.where((leaf_depth - d) % 2 == 0, leaf, -leaf)
            visits[rows, slot] += on.to(torch.int32)
            values[rows, slot] = torch.where(on, values[rows, slot] + sign, values[rows, slot])
            on_edge = d < leaf_depth
            ea = took[:, d].clamp_min(0)
            edge_visits[rows, slot, ea] += on_edge.to(torch.int32)
            # the edge keeps the value from the child's side
            edge_values[rows, slot, ea] = torch.where(
                on_edge, edge_values[rows, slot, ea] - sign, edge_values[rows, slot, ea])
        fed.append(reached)
        expanded.append(grow)
        new_slot.append(new)
        new_terminal.append(seen.terminal)

    tree_mismatch += (tree.num_nodes != count).to(torch.int64)
    ev, evs = edge_visits[:, 0], edge_values[:, 0]
    q = torch.where(ev > 0, -evs / ev.clamp_min(1), 0.0)
    root_value = values[:, 0] / visits[:, 0].clamp_min(1)
    visit_mismatch = (result.visit_counts != ev.to(f32)).sum(dim=1)
    value_gap = torch.maximum((result.root_value - root_value).abs(),
                              (result.q_values - q).abs().amax(dim=1))
    return Replay(engine_mismatch, tree_mismatch, visit_mismatch, value_gap, fed,
                  torch.stack(expanded), torch.stack(new_slot), torch.stack(new_terminal))
