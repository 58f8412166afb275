"""Array-tree batched MCTS in PyTorch.

Port of ``othello_reinforcement_learning_test_tpu/search/mcts.py``: every
game carries a node pool of ``num_simulations + 1`` slots, selection,
expansion and backup are batched tensor ops, and all leaf evaluations of a
simulation go through one network call.

The JAX package writes every per-game row read and write as a dense one-hot
blend, a TPU choice (no fast irregular gather there). Here they are
``gather``, ``scatter`` and index writes, with the same results: each path
holds a node at most once, so every backup adds exactly one value to each
touched slot.

Semantics, as in the reference: canonical PUCT (the parent maximizes
``-Q(child) + U``), priors masked to legal actions with a uniform fallback,
optional root Dirichlet noise, terminal leaves valued by the game's winner,
sign-flipping backup, and root statistics updated by every backup. Argmax
ties go to the lowest index (``torch.argmax``).

No collective runs inside the search. Under data parallelism each rank
searches its own games, its loops (the select walk's liveness test
included) are its own, and nothing the search computes crosses ranks; the
root noise of a rank's games is its rows of the draw at the global batch's
shape (``rows``). That is why the port's ``global`` self-play design needs
no all-reduced liveness condition, where the JAX program lowers it to one
under a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..ops.bitboard import Board, OthelloEngine
from ..parallel.mesh import Rows, draw_rows

NO_CHILD = -1

Net = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclass
class Tree:
    """Batched node pools, (B, N, ...) with N = num_simulations + 1; slot 0
    is the root. Updated in place by :func:`_expand_and_backup`."""

    board_me: torch.Tensor  # (B, N) int64
    board_opp: torch.Tensor  # (B, N) int64
    visit: torch.Tensor  # (B, N) int32
    value_sum: torch.Tensor  # (B, N) f32, from the node's own perspective
    prior: torch.Tensor  # (B, N, A) f32
    children: torch.Tensor  # (B, N, A) int64, NO_CHILD when absent
    # per-edge statistics stored at the parent, from the child's perspective
    child_visit: torch.Tensor  # (B, N, A) int32
    child_value_sum: torch.Tensor  # (B, N, A) f32
    legal: torch.Tensor  # (B, N, A) bool
    terminal: torch.Tensor  # (B, N) bool
    term_value: torch.Tensor  # (B, N) f32, game winner at terminal nodes
    # raw leaf evaluation (NN value, or winner at terminals), kept so a
    # search rooted at this node can skip its root forward
    nn_value: torch.Tensor  # (B, N) f32
    num_nodes: torch.Tensor  # (B,) int64


class SearchResult(NamedTuple):
    visit_counts: torch.Tensor  # (B, A) f32 root child visit counts
    root_value: torch.Tensor  # (B,) f32 mean value at the root (mover's view)
    q_values: torch.Tensor  # (B, A) f32 per-action Q, mover's view
    legal: torch.Tensor  # (B, A) bool
    root_terminal: torch.Tensor  # (B,) bool


class RootCache(NamedTuple):
    """A root evaluation taken from the previous search's tree
    (:func:`extract_root_cache`) instead of ``observe`` plus one network
    call; the network is deterministic, so reuse changes nothing."""

    prior: torch.Tensor  # (B, A) f32 masked_probs, noise not applied
    value: torch.Tensor  # (B,) f32 NN value (winner at terminals)
    legal: torch.Tensor  # (B, A) bool
    terminal: torch.Tensor  # (B,) bool
    winner: torch.Tensor  # (B,) f32


class _Selection(NamedTuple):
    parent: torch.Tensor  # (B,) node to expand from (or the terminal node)
    action: torch.Tensor  # (B,)
    path: torch.Tensor  # (B, N) visited nodes, -1 padded
    path_action: torch.Tensor  # (B, N) action taken from path[i]
    path_len: torch.Tensor  # (B,)
    is_term_leaf: torch.Tensor  # (B,) bool, stopped at an existing terminal


def _rows(arr: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """``arr[b, node[b], ...]`` for every game b."""
    return arr[torch.arange(arr.shape[0], device=arr.device), node]


def _write_rows(arr: torch.Tensor, node: torch.Tensor, value: torch.Tensor,
                pred: torch.Tensor) -> None:
    """``arr[b, node[b], ...] = value[b]`` where ``pred[b]``, in place."""
    b = torch.arange(arr.shape[0], device=arr.device)
    keep = arr[b, node]
    arr[b, node] = torch.where(pred.view(-1, *[1] * (keep.dim() - 1)), value, keep)


def extract_root_cache(tree: Tree, action: torch.Tensor) -> RootCache:
    """RootCache of the position reached by playing ``action`` at the root.
    Valid only for actions whose child is expanded (>= 1 root visit)."""
    child = tree.children[:, 0].gather(1, action[:, None])[:, 0]
    return RootCache(
        prior=_rows(tree.prior, child),
        value=_rows(tree.nn_value, child),
        legal=_rows(tree.legal, child),
        terminal=_rows(tree.terminal, child),
        winner=_rows(tree.term_value, child),
    )


def masked_probs(log_probs: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """exp(log_probs) masked to legal actions and renormalized; uniform over
    legal actions when the mass vanishes."""
    probs = torch.exp(log_probs) * legal
    total = probs.sum(dim=-1, keepdim=True)
    n_legal = legal.sum(dim=-1, keepdim=True).clamp_min(1)
    uniform = legal / n_legal
    return torch.where(total > 1e-8, probs / total.clamp_min(1e-8), uniform)


def add_dirichlet_noise(generator: torch.Generator, prior: torch.Tensor,
                        legal: torch.Tensor, alpha: float,
                        eps: float, rows: Optional[Rows] = None) -> torch.Tensor:
    """Mix the root prior with Dirichlet(alpha) noise over legal actions:
    ``(1 - eps) * prior + eps * noise``, zero on illegal actions. With
    ``rows``, the games are those rows of a global batch, and the gamma
    draws are taken at its shape."""
    gamma = draw_rows(lambda shape: torch._standard_gamma(
        torch.full(shape, alpha, dtype=prior.dtype, device=prior.device),
        generator=generator), prior.shape, rows)
    gamma = gamma * legal
    noise = gamma / gamma.sum(dim=-1, keepdim=True).clamp_min(1e-8)
    return torch.where(legal, (1.0 - eps) * prior + eps * noise, 0.0)


def _puct_best(tree: Tree, c_puct: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best PUCT action and its child slot for every node at once: (B, N)
    each (NO_CHILD where unexpanded). The tree does not change during one
    selection walk, so this is computed once per simulation.

    The exploration root is the correctly rounded f32 one, taken in float64
    and rounded once, as XLA's and CUDA's are: PyTorch's vectorized f32
    ``sqrt`` on the CPU is an ulp off near ties (first at 267 visits)."""
    c_visit = tree.child_visit
    q = torch.where(c_visit > 0,
                    -tree.child_value_sum / c_visit.clamp_min(1), 0.0)
    root = torch.sqrt(tree.visit.clamp_min(1).to(torch.float64)).to(torch.float32)
    u = (c_puct * tree.prior * root[:, :, None]
         / (1.0 + c_visit.to(torch.float32)))
    scores = torch.where(tree.legal, q + u, -torch.inf)
    act_star = torch.argmax(scores, dim=-1)  # (B, N)
    child_star = tree.children.gather(2, act_star[:, :, None])[:, :, 0]
    return act_star, child_star


def _select(tree: Tree, c_puct: float, cond_interval: int = 1) -> _Selection:
    """Walk every game from its root by PUCT until an unexpanded edge or a
    terminal node, in lockstep; the loop runs until no walker is left.

    The liveness test is a host sync; with ``cond_interval`` k it runs once
    every k walk steps. A step is a no-op for finished walkers (every
    update is gated on ``walking``), so the result is the same for any k."""
    B, n_slots = tree.visit.shape
    dev = tree.visit.device
    path = torch.full((B, n_slots), -1, dtype=torch.int64, device=dev)
    path[:, 0] = 0
    pact = torch.full((B, n_slots), -1, dtype=torch.int64, device=dev)
    act_star, child_star = _puct_best(tree, c_puct)

    node = torch.zeros(B, dtype=torch.int64, device=dev)
    action = torch.full((B,), NO_CHILD, dtype=torch.int64, device=dev)
    depth = torch.zeros(B, dtype=torch.int64, device=dev)
    stop_term = tree.terminal[:, 0].clone()
    walking = ~stop_term & (action == NO_CHILD)
    steps = 0
    while steps % cond_interval or bool(walking.any()):
        steps += 1
        act = act_star.gather(1, node[:, None])[:, 0]
        child = child_star.gather(1, node[:, None])[:, 0]
        descend = walking & (child != NO_CHILD)
        # the edge taken from this node (the final unexpanded edge is
        # recorded after expansion)
        _write_rows(pact, depth, act, descend)
        nxt = torch.where(descend, child, node)
        depth = depth + descend.to(torch.int64)
        _write_rows(path, depth, nxt, descend)
        term_nxt = tree.terminal.gather(1, nxt[:, None])[:, 0]
        stop_term = torch.where(walking, descend & term_nxt, stop_term)
        action = torch.where(walking, torch.where(descend, NO_CHILD, act), action)
        node = nxt
        walking = ~stop_term & (action == NO_CHILD)

    is_term = stop_term | (action == NO_CHILD)
    return _Selection(
        parent=node,
        action=torch.where(is_term, 0, action),
        path=path,
        path_action=pact,
        path_len=depth + 1,
        is_term_leaf=is_term,
    )


def _expand_and_backup(tree: Tree, sel: _Selection, child_me: torch.Tensor,
                       child_opp: torch.Tensor, child_prior: torch.Tensor,
                       child_legal: torch.Tensor, child_terminal: torch.Tensor,
                       child_winner: torch.Tensor, nn_value: torch.Tensor) -> None:
    """Write the new leaf (unless the walk stopped on an existing terminal
    node) and back its value up the path with alternating signs, in place.

    Slot indices stay in range: before simulation i the tree holds at most
    i + 1 <= N - 1 nodes, so the new slot and the path end are < N."""
    B, n_slots = tree.visit.shape
    A = tree.prior.shape[-1]
    dev = tree.visit.device
    new_idx = tree.num_nodes
    expand = ~sel.is_term_leaf

    raw_value = torch.where(child_terminal, child_winner.to(torch.float32), nn_value)
    leaf_value = torch.where(
        sel.is_term_leaf, tree.term_value.gather(1, sel.parent[:, None])[:, 0],
        raw_value)

    for arr, val in ((tree.board_me, child_me), (tree.board_opp, child_opp),
                     (tree.prior, child_prior), (tree.legal, child_legal),
                     (tree.terminal, child_terminal),
                     (tree.term_value, child_winner.to(torch.float32)),
                     (tree.nn_value, raw_value)):
        _write_rows(arr, new_idx, val, expand)
    b = torch.arange(B, device=dev)
    edge = tree.children[b, sel.parent, sel.action]
    tree.children[b, sel.parent, sel.action] = torch.where(expand, new_idx, edge)
    tree.num_nodes = tree.num_nodes + expand.to(torch.int64)

    # full backup path: the selection path plus the new leaf when expanding
    path, pact = sel.path.clone(), sel.path_action.clone()
    _write_rows(path, sel.path_len, new_idx, expand)
    _write_rows(pact, sel.path_len - 1, sel.action, expand)
    path_len = sel.path_len + expand.to(torch.int64)

    idx = torch.arange(n_slots, device=dev)[None, :]  # path positions
    lv = leaf_value[:, None]
    on_path = idx < path_len[:, None]
    # the leaf sits at depth path_len - 1; the sign alternates walking up
    parity = (path_len[:, None] - 1 - idx) % 2
    signed = torch.where(on_path, torch.where(parity == 0, lv, -lv), 0.0)
    safe = torch.where(on_path, path, 0)
    tree.visit.scatter_add_(1, safe, on_path.to(torch.int32))
    tree.value_sum.scatter_add_(1, safe, signed)

    # edge (path[i], pact[i]) leads to path[i + 1]; it stores the value from
    # the child's perspective (the sign at depth i + 1)
    on_edge = idx < (path_len - 1)[:, None]
    child_signed = torch.where(
        on_edge,
        torch.where((path_len[:, None] - 2 - idx) % 2 == 0, lv, -lv), 0.0)
    flat = torch.where(on_edge, safe * A + pact, 0)
    tree.child_visit.view(B, n_slots * A).scatter_add_(1, flat, on_edge.to(torch.int32))
    tree.child_value_sum.view(B, n_slots * A).scatter_add_(1, flat, child_signed)


def _step_leaf(engine: OthelloEngine, tree: Tree, sel: _Selection, zeros: torch.Tensor):
    """Play the selected edge from its parent: ``(child board, legal,
    terminal, winner, features)``. ``zeros``: (B,) move counts of 0."""
    parent = Board(me=_rows(tree.board_me, sel.parent),
                   opp=_rows(tree.board_opp, sel.parent),
                   move_count=zeros, passed=zeros.to(torch.bool))
    # the parent's pass legality is cached in the tree, so step skips its
    # legal-move flood
    pass_legal = _rows(tree.legal, sel.parent)[:, engine.pass_action]
    child, _ = engine.step(parent, sel.action, pass_legal=pass_legal)
    return (child, *engine.observe(child, with_features=True))


def _simulate(engine: OthelloEngine, net: Net, tree: Tree, zeros: torch.Tensor,
              c_puct: float, cond_interval: int = 1) -> None:
    """One simulation, in place: select a leaf, step to it, evaluate it with
    one network call for every game, expand and back up. Its parts are
    :func:`_select`, :func:`_step_leaf`, ``net``, :func:`masked_probs` and
    :func:`_expand_and_backup`, which ``profilers/profile_mcts_parts.py``
    times one by one."""
    sel = _select(tree, c_puct, cond_interval)
    child, c_legal, c_term, c_win, feats = _step_leaf(engine, tree, sel, zeros)
    log_p, v = net(feats)
    _expand_and_backup(tree, sel, child.me, child.opp, masked_probs(log_p, c_legal),
                       c_legal, c_term, c_win, v[:, 0])


def _init_tree(n_slots: int, me: torch.Tensor, opp: torch.Tensor,
               prior: torch.Tensor, legal: torch.Tensor, terminal: torch.Tensor,
               winner: torch.Tensor, value: torch.Tensor) -> Tree:
    """Empty node pools with the root written at slot 0."""
    B, A = prior.shape
    dev = prior.device

    def zeros(*shape, dtype):
        return torch.zeros((B, n_slots, *shape), dtype=dtype, device=dev)

    tree = Tree(
        board_me=zeros(dtype=torch.int64),
        board_opp=zeros(dtype=torch.int64),
        visit=zeros(dtype=torch.int32),
        value_sum=zeros(dtype=torch.float32),
        prior=zeros(A, dtype=torch.float32),
        children=torch.full((B, n_slots, A), NO_CHILD, dtype=torch.int64, device=dev),
        child_visit=zeros(A, dtype=torch.int32),
        child_value_sum=zeros(A, dtype=torch.float32),
        legal=zeros(A, dtype=torch.bool),
        terminal=zeros(dtype=torch.bool),
        term_value=zeros(dtype=torch.float32),
        nn_value=zeros(dtype=torch.float32),
        num_nodes=torch.ones(B, dtype=torch.int64, device=dev),
    )
    tree.board_me[:, 0] = me
    tree.board_opp[:, 0] = opp
    tree.visit[:, 0] = 1
    tree.value_sum[:, 0] = value
    tree.prior[:, 0] = prior
    tree.legal[:, 0] = legal
    tree.terminal[:, 0] = terminal
    tree.term_value[:, 0] = winner.to(torch.float32)
    tree.nn_value[:, 0] = value
    return tree


def search(engine: OthelloEngine, net: Net, boards: Board, num_simulations: int,
           c_puct: float = 1.0, dirichlet_alpha: float = 0.3,
           dirichlet_epsilon: float = 0.25, add_noise: bool = False,
           generator: Optional[torch.Generator] = None,
           root_cache: Optional[RootCache] = None, return_tree: bool = False,
           cond_interval: int = 1, rows: Optional[Rows] = None):
    """Batched MCTS from a batch of root boards (one batch axis). Returns a
    :class:`SearchResult`, or ``(SearchResult, Tree)`` with ``return_tree``.

    ``net``: (B, S, S, 3) f32 -> (log_probs (B, A), value (B, 1)), eval
    mode. ``generator`` draws the root noise (needed with ``add_noise``).
    ``root_cache`` supplies the root evaluation from a previous search's
    tree and skips the root observe and forward. ``cond_interval``
    decimates the select walk's liveness test (:func:`_select`); results
    are the same for any value. ``rows``: the boards are those rows of a
    global batch, whose root noise is drawn at the global shape.
    """
    if boards.me.dim() != 1:
        raise ValueError("search expects a single batch axis")
    n_slots = num_simulations + 1

    if root_cache is None:
        legal0, term0, win0, feats = engine.observe(boards, with_features=True)
        log_p, v0 = net(feats)
        prior0 = masked_probs(log_p, legal0)
        win0 = win0.to(torch.float32)
        root_value0 = torch.where(term0, win0, v0[:, 0])
    else:
        prior0, root_value0, legal0, term0, win0 = root_cache
    if add_noise:
        prior0 = add_dirichlet_noise(generator, prior0, legal0, dirichlet_alpha,
                                     dirichlet_epsilon, rows)

    tree = _init_tree(n_slots, boards.me, boards.opp, prior0, legal0, term0,
                      win0, root_value0)
    zeros = torch.zeros_like(boards.move_count)
    for _ in range(num_simulations):
        _simulate(engine, net, tree, zeros, c_puct, cond_interval)

    root_cv = tree.child_visit[:, 0]
    q_values = torch.where(root_cv > 0,
                           -tree.child_value_sum[:, 0] / root_cv.clamp_min(1), 0.0)
    result = SearchResult(
        visit_counts=root_cv.to(torch.float32),
        root_value=tree.value_sum[:, 0] / tree.visit[:, 0].clamp_min(1),
        q_values=q_values,
        legal=legal0,
        root_terminal=term0,
    )
    return (result, tree) if return_tree else result


def action_probs_from_counts(counts: torch.Tensor, legal: torch.Tensor,
                             temperature) -> torch.Tensor:
    """Visit counts -> action distribution: t = 0 gives the argmax one-hot,
    otherwise ``counts**(1/t)`` renormalized. ``temperature`` is a float or a
    (B,) tensor."""
    t = torch.as_tensor(temperature, dtype=torch.float32, device=counts.device)
    t = t.expand(counts.shape[:-1])[..., None]
    counts = torch.where(legal, counts, 0.0)
    best = torch.argmax(counts, dim=-1)
    onehot = torch.nn.functional.one_hot(best, counts.shape[-1]).to(torch.float32)
    safe_t = t.clamp_min(1e-3)
    # dividing by the max count first keeps every base <= 1, so small
    # temperatures cannot overflow float32
    cmax = counts.amax(dim=-1, keepdim=True).clamp_min(1e-9)
    powered = torch.pow(counts.clamp_min(0.0) / cmax, 1.0 / safe_t)
    # summed in float64, where at temperature 1 (counts / cmax, the pi
    # targets) every partial sum is exact: the result then does not depend
    # on the order of the sum, so the card and the CPU give the same bits
    total = powered.to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)
    n_legal = legal.sum(dim=-1, keepdim=True).clamp_min(1)
    uniform = legal / n_legal
    powered = torch.where(total > 0, powered / total.clamp_min(1e-8), uniform)
    return torch.where(t <= 1e-4, onehot, powered)


def best_action(counts: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Argmax action over visit counts, restricted to legal actions."""
    return torch.argmax(torch.where(legal, counts, -1.0), dim=-1)


def action_evaluations(result: SearchResult) -> torch.Tensor:
    """Per-action evaluations in [0, 100] for hint UIs; Q from the mover's
    view; -1 for unvisited or illegal actions."""
    visited = (result.visit_counts > 0) & result.legal
    scaled = torch.round((result.q_values + 1.0) * 50.0)
    return torch.where(visited, scaled, -1.0)


class MCTS:
    """Object facade with the reference search API: ``search``,
    ``get_action_probs``, ``get_best_action``, ``get_action_evaluations``,
    on batched boards."""

    def __init__(self, engine: OthelloEngine, net: Net, num_simulations: int = 25,
                 c_puct: float = 1.0, dirichlet_alpha: float = 0.3,
                 dirichlet_epsilon: float = 0.25):
        self.engine = engine
        self.net = net
        self.num_simulations = num_simulations
        self.c_puct = c_puct
        self.dirichlet_alpha = dirichlet_alpha
        self.dirichlet_epsilon = dirichlet_epsilon

    def search(self, boards: Board, generator: Optional[torch.Generator] = None,
               add_noise: bool = False) -> SearchResult:
        return search(self.engine, self.net, boards, self.num_simulations,
                      c_puct=self.c_puct, dirichlet_alpha=self.dirichlet_alpha,
                      dirichlet_epsilon=self.dirichlet_epsilon,
                      add_noise=add_noise, generator=generator)

    def get_action_probs(self, boards: Board, generator=None,
                         temperature: float = 1.0,
                         add_noise: bool = False) -> torch.Tensor:
        res = self.search(boards, generator, add_noise=add_noise)
        return action_probs_from_counts(res.visit_counts, res.legal, temperature)

    def get_best_action(self, boards: Board) -> torch.Tensor:
        res = self.search(boards)
        return best_action(res.visit_counts, res.legal)

    def get_action_evaluations(self, boards: Board) -> torch.Tensor:
        """Per-action 0-100 evaluations for hint UIs (-1 = unvisited)."""
        return action_evaluations(self.search(boards))
