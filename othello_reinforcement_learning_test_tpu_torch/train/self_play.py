"""Batched self-play in PyTorch.

Port of ``othello_reinforcement_learning_test_tpu/train/self_play.py``:
``num_games`` games step in lockstep; every ply runs the batched MCTS (one
network call per simulation for all games), samples actions with the
temperature schedule, records (board, pi, parity), and at the end assigns
each step the game's outcome from that step's mover's view.

- temperature 1.0 while ``move_count < temperature_threshold``, else 0
  (argmax); zero-visit actions get a ``-inf`` logit, so they are never
  sampled;
- the recorded policy is the temperature-1 visit distribution;
- outcome parity is taken from the final side to move;
- root-eval reuse: the root evaluation of ply t+1 is the chosen child's
  cached evaluation from ply t's tree, so only the first ply runs a root
  forward.

The JAX ``while_loop`` is a Python loop over plies that stops when no game
is live; ``cond_interval`` k tests that (a host sync) once every k plies,
and the search's walk likewise. The JAX ``mesh`` is ``shard=(rank,
world)``: the rank plays its slice of the global batch, and takes every
random draw (root noise, sampled actions) at the global batch's shape from
the one seeded generator, then slices it. So the ranks' trajectories,
concatenated in rank order, are the unsharded run's on a network whose rows
do not depend on the batch (the int8 trunks' per-block scale does).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.bitboard import OthelloEngine
from ..parallel import mesh
from ..parallel.mesh import Rows, draw_rows, shard_rows
from ..search import mcts
from ..utils import profiling
from ..utils.device import resolve_device


class Trajectory(NamedTuple):
    """Self-play results, (B, T, ...); ``mask`` marks real plies."""

    me: torch.Tensor  # (B, T) int64 board of the side to move
    opp: torch.Tensor  # (B, T) int64
    pi: torch.Tensor  # (B, T, A) f32 MCTS visit distribution
    value: torch.Tensor  # (B, T) f32 outcome from the mover's view
    mask: torch.Tensor  # (B, T) bool
    final_me_count: torch.Tensor  # (B,) int32
    final_opp_count: torch.Tensor  # (B,) int32
    winner_black: torch.Tensor  # (B,) int32: +1 black wins, -1 white, 0 draw
    num_moves: torch.Tensor  # (B,) int32


def max_game_length(size: int) -> int:
    """Ply cap: every placement may be preceded by a pass, plus the closing
    double pass."""
    return 2 * size * size + 4


def auto_cond_interval(process_count: Optional[int] = None,
                       platform: Optional[str] = None) -> int:
    """The default ``cond_interval`` (``self_play.cond_interval`` unset or
    ``"auto"``), the JAX package's rule: 4 when more than one process runs
    off a TPU, else 1. ``platform`` defaults to this process's, which is
    never ``"tpu"`` here."""
    if process_count is None:
        process_count = mesh.process_count()
    if process_count <= 1 or platform == "tpu":
        return 1
    return 4


def _sample(probs: torch.Tensor, generator: torch.Generator,
            rows: Optional[Rows] = None) -> torch.Tensor:
    """One categorical draw per row by the Gumbel-max trick; actions with
    zero probability have a -inf logit and are never drawn. With ``rows``,
    the uniforms are those rows of a draw at the global batch's shape."""
    logits = torch.where(probs > 0, torch.log(probs.clamp_min(1e-30)), -torch.inf)
    u = draw_rows(lambda shape: torch.rand(shape, generator=generator, device=probs.device),
                  probs.shape, rows)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _keep(live: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(live.view(-1, *[1] * (new.dim() - 1)), new, old)


@torch.no_grad()
def play_games(engine: OthelloEngine, net: mcts.Net, num_games: int,
               num_simulations: int, c_puct: float = 1.0,
               dirichlet_alpha: float = 0.3, dirichlet_epsilon: float = 0.25,
               temperature_threshold: int = 15, add_noise: bool = True,
               seed: int = 0, device=None, cond_interval: int = 1,
               shard: Optional[Tuple[int, int]] = None) -> Trajectory:
    """Play ``num_games`` complete games in lockstep on ``device`` (CUDA
    unless ``"cpu"`` is asked for). ``net`` maps (B, S, S, 3) features on
    that device to ``(log_probs, value)``; ``seed`` seeds the generator that
    draws the root noise and the sampled actions. ``cond_interval``: test
    liveness every that many plies and walk steps (the same results for
    any value). ``shard=(rank, world)``: play only that rank's slice of the
    ``num_games`` (see the module docstring). Each liveness test is a host
    sync, the span ``sync.live`` while tracing."""
    # Root-eval reuse needs the sampled action's child to be expanded, which
    # holds only when at least one simulation ran.
    if num_simulations < 1:
        raise ValueError(
            f"play_games requires num_simulations >= 1 (got {num_simulations}); "
            "root-eval reuse depends on the chosen action's child being expanded")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = shard_rows(num_games, shard)
    B = num_games if rows is None else rows[1].stop - rows[1].start
    T, A = max_game_length(engine.size), engine.num_actions

    boards = engine.initial_state((B,), device=dev)
    t_me = torch.zeros((B, T), dtype=torch.int64, device=dev)
    t_opp = torch.zeros_like(t_me)
    t_pi = torch.zeros((B, T, A), dtype=torch.float32, device=dev)
    t_par = torch.zeros((B, T), dtype=torch.int32, device=dev)
    t_mask = torch.zeros((B, T), dtype=torch.bool, device=dev)

    legal, term, win, feats = engine.observe(boards, with_features=True)
    log_p, v = net(feats)
    win = win.to(torch.float32)
    cache = mcts.RootCache(prior=mcts.masked_probs(log_p, legal),
                           value=torch.where(term, win, v[:, 0]),
                           legal=legal, terminal=term, winner=win)

    for t in range(T):
        live = ~cache.terminal
        if t % cond_interval == 0 and not profiling.host_bool(live.any(), "sync.live"):
            break
        res, tree = mcts.search(
            engine, net, boards, num_simulations, c_puct=c_puct,
            dirichlet_alpha=dirichlet_alpha, dirichlet_epsilon=dirichlet_epsilon,
            add_noise=add_noise, generator=gen, root_cache=cache,
            return_tree=True, cond_interval=cond_interval, rows=rows)
        pi = mcts.action_probs_from_counts(res.visit_counts, res.legal, 1.0)
        temp = torch.where(boards.move_count < temperature_threshold, 1.0, 0.0)
        action = _sample(
            mcts.action_probs_from_counts(res.visit_counts, res.legal, temp), gen, rows)

        t_me[:, t] = torch.where(live, boards.me, 0)
        t_opp[:, t] = torch.where(live, boards.opp, 0)
        t_pi[:, t] = torch.where(live[:, None], pi, 0.0)
        t_par[:, t] = torch.where(live, boards.move_count % 2, 0)
        t_mask[:, t] = live

        nxt, _ = engine.step(boards, action,
                             pass_legal=res.legal[:, engine.pass_action])
        boards = type(boards)(*(_keep(live, n, o) for n, o in zip(nxt, boards)))
        # dead games keep their (terminal) cache, so they stay dead
        cache = mcts.RootCache(*(_keep(live, n, o) for n, o in
                                 zip(mcts.extract_root_cache(tree, action), cache)))

    # outcome: winner from the final side to move, re-expressed per step
    w_final = engine.winner(boards)
    final_parity = boards.move_count % 2
    same = (t_par == final_parity[:, None]).to(torch.float32)
    value = w_final[:, None].to(torch.float32) * (2.0 * same - 1.0)
    value = torch.where(t_mask, value, 0.0)
    c_me, c_opp = engine.stone_counts(boards)
    # black is the side whose parity is 0 at the end
    winner_black = torch.where(final_parity == 0, w_final, -w_final)
    return Trajectory(me=t_me, opp=t_opp, pi=t_pi, value=value, mask=t_mask,
                      final_me_count=c_me, final_opp_count=c_opp,
                      winner_black=winner_black, num_moves=boards.move_count)


class SelfPlayWorker:
    """Object facade with the reference worker API: ``execute_episodes`` /
    ``execute_episode``, all episodes batched in lockstep."""

    def __init__(self, engine: OthelloEngine, net: mcts.Net,
                 num_simulations: int = 25, c_puct: float = 1.0,
                 dirichlet_alpha: float = 0.3, dirichlet_epsilon: float = 0.25,
                 temperature_threshold: int = 15, device=None):
        self.engine = engine
        self.net = net
        self.num_simulations = num_simulations
        self.c_puct = c_puct
        self.dirichlet_alpha = dirichlet_alpha
        self.dirichlet_epsilon = dirichlet_epsilon
        self.temperature_threshold = temperature_threshold
        self.device = resolve_device(device)

    def execute_episodes(self, num_episodes: int, seed: int = 0,
                         add_noise: bool = True) -> Trajectory:
        return play_games(
            self.engine, self.net, num_episodes, self.num_simulations,
            c_puct=self.c_puct, dirichlet_alpha=self.dirichlet_alpha,
            dirichlet_epsilon=self.dirichlet_epsilon,
            temperature_threshold=self.temperature_threshold,
            add_noise=add_noise, seed=seed, device=self.device)

    def execute_episode(self, seed: int = 0, add_noise: bool = True) -> Trajectory:
        return self.execute_episodes(1, seed=seed, add_noise=add_noise)
