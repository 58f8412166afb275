"""Per-part split of one MCTS simulation on a mid-search tree.

    python -m othello_reinforcement_learning_test_tpu_torch.profilers.profile_mcts_parts \\
        [--batch 1024] [--reps 400] [--device cpu]

Port of the JAX package's ``scripts/profile_mcts_parts.py`` (which stays
JAX-only): the same flags and defaults, with ``--device`` (CUDA unless
``cpu`` is asked for; no fallback) in place of ``--platform``, and
``--blocks``, ``--filters`` and ``--net-variant`` added (the JAX script's
network is the plain forward at 10x128). It builds the JAX script's
mid-search tree (:func:`build_mid_tree`: ``--warm-sims`` of ``--sims``
simulations done from the initial position, then one more selection, child
and forward), then times each part of ``search/mcts.py::_simulate`` at that
state with ``profilers/common.py``'s harness:

- the select walk, ``_select`` (one host sync a walk step);
- the parent gather + ``engine.step`` + ``observe(with_features=True)``,
  ``_step_leaf``;
- the network forward;
- ``masked_probs``;
- ``_expand_and_backup``, from a snapshot of the tree restored before each
  call outside the timed window;

and one whole simulation at the same state, beside the sum of the parts.
The same operations on the same state give the same device operations, so
the parts' launches sum to the whole's. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import fields
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from ..models.fused_resnet import PORTED_VARIANTS, FusedInference
from ..ops.bitboard import Board, OthelloEngine, get_engine
from ..search import mcts
from ..train.trainer import apply_eval
from ..utils.device import resolve_device
from .common import Harness, device_record, finish, initial_model

NET_VARIANTS = ("xla",) + PORTED_VARIANTS
C_PUCT = 1.0


def make_net(blocks: int, filters: int, variant: str, dev: torch.device) -> mcts.Net:
    """The trainer's initial weights at seed 0 through ``variant``: the
    plain eval forward (``xla``) or a ``FusedInference`` variant."""
    model = initial_model(blocks, filters, dev)
    return apply_eval(model) if variant == "xla" else FusedInference(model, variant)


class MidTree(NamedTuple):
    """A tree after ``warm_sims`` simulations and the inputs of the next
    simulation's parts: its selection, child board, the child's legal,
    terminal, winner and features, the forward's log-probs and value, and
    the masked prior."""

    tree: mcts.Tree
    sel: mcts._Selection
    child: Board
    legal: torch.Tensor
    terminal: torch.Tensor
    winner: torch.Tensor
    feats: torch.Tensor
    log_p: torch.Tensor
    value: torch.Tensor
    prior: torch.Tensor
    zeros: torch.Tensor


@torch.no_grad()
def build_mid_tree(engine: OthelloEngine, net: mcts.Net, batch: int, sims: int,
                   warm_sims: int, dev: torch.device) -> MidTree:
    """The JAX script's recipe (``scripts/profile_mcts_parts.py:54-103``):
    ``batch`` games at the initial position, a root forward, a tree of
    ``sims + 1`` slots, ``warm_sims`` simulations (no root noise), then one
    more selection, child, forward and masked prior."""
    if not 0 <= warm_sims < sims:
        raise ValueError(f"warm_sims must be in [0, sims) (got {warm_sims}, {sims})")
    boards = engine.initial_state((batch,), device=dev)
    legal0, term0, win0, feats0 = engine.observe(boards, with_features=True)
    log_p0, v0 = net(feats0)
    win0 = win0.to(torch.float32)
    tree = mcts._init_tree(sims + 1, boards.me, boards.opp, mcts.masked_probs(log_p0, legal0),
                           legal0, term0, win0, torch.where(term0, win0, v0[:, 0]))
    zeros = torch.zeros_like(boards.move_count)
    for _ in range(warm_sims):
        mcts._simulate(engine, net, tree, zeros, C_PUCT)
    sel = mcts._select(tree, C_PUCT)
    child, legal, term, win, feats = mcts._step_leaf(engine, tree, sel, zeros)
    log_p, v = net(feats)
    return MidTree(tree, sel, child, legal, term, win, feats, log_p, v[:, 0],
                   mcts.masked_probs(log_p, legal), zeros)


def snapshot(tree: mcts.Tree) -> Callable[[], None]:
    """A restore of every array of ``tree`` to its present contents, in
    place."""
    saved = {f.name: getattr(tree, f.name).clone() for f in fields(tree)}

    def restore() -> None:
        for name, value in saved.items():
            getattr(tree, name).copy_(value)

    return restore


def parts(engine: OthelloEngine, net: mcts.Net, mid: MidTree) -> Dict[str, Callable[[], object]]:
    """The five parts of ``mcts._simulate`` at the mid-search state, in
    order, each as a call that runs it on that state."""
    t, s = mid.tree, mid.sel
    return {
        "select walk": lambda: mcts._select(t, C_PUCT),
        "parent gather+step+obs": lambda: mcts._step_leaf(engine, t, s, mid.zeros),
        "forward": lambda: net(mid.feats),
        "masked_probs": lambda: mcts.masked_probs(mid.log_p, mid.legal),
        "expand+backup": lambda: mcts._expand_and_backup(
            t, s, mid.child.me, mid.child.opp, mid.prior, mid.legal, mid.terminal, mid.winner,
            mid.value),
    }


# the parts that write the tree in place, timed from the snapshot
WRITES_TREE = ("expand+backup", "whole simulation")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--sims", type=int, default=25)
    ap.add_argument("--warm-sims", type=int, default=12)
    ap.add_argument("--reps", type=int, default=400, help="calls a repeat")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--filters", type=int, default=128)
    ap.add_argument("--net-variant", choices=NET_VARIANTS, default="xla",
                    help="the network: the plain eval forward (xla, the JAX script's) or a "
                         "FusedInference variant")
    ap.add_argument("--device", default=None, help="torch device: CUDA unless 'cpu' is asked for")
    return ap.parse_args(argv)


@torch.no_grad()
def run(argv: Optional[List[str]] = None) -> Dict:
    """Print the rows and return the JSON object."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    engine = get_engine(8)
    net = make_net(args.blocks, args.filters, args.net_variant, dev)
    mid = build_mid_tree(engine, net, args.batch, args.sims, args.warm_sims, dev)
    restore = snapshot(mid.tree)
    h = Harness(dev, args.reps, args.repeats, unit="us")
    h.null()
    rows = {}
    for name, part in parts(engine, net, mid).items():
        rows[name] = h.time(name, part, restore=restore if name in WRITES_TREE else None,
                            forwards=int(name == "forward"))
    whole = h.time("whole simulation",
                   lambda: mcts._simulate(engine, net, mid.tree, mid.zeros, C_PUCT),
                   restore=restore, forwards=1)
    total = sum(r["wall_ms_net"]["best"] for r in rows.values())
    print(f"{'sum of parts':34s}: {total * 1e3:9.3f} us   "
          f"(whole simulation {whole['wall_ms_net']['best'] * 1e3:.3f} us)")
    launches = [r["launches"] for r in rows.values()]
    sums = {"wall_ms_net": total, "wall_ms_whole": whole["wall_ms_net"]["best"]}
    if all(isinstance(n, int) for n in launches):
        sums["launches"] = sum(launches)
        sums["launches_whole"] = whole["launches"]
        busy = [r["device_busy_ms"] for r in rows.values()]
        sums["device_busy_ms"] = sum(busy) if all(isinstance(b, float) for b in busy) else None
        sums["device_busy_ms_whole"] = whole["device_busy_ms"]
    print(f"(B={args.batch}, tree at {args.warm_sims}/{args.sims} simulations, "
          f"{args.blocks}x{args.filters} {args.net_variant})")
    return {"profiler": "profile_mcts_parts", "batch": args.batch, "sims": args.sims,
            "warm_sims": args.warm_sims, "reps": args.reps, "repeats": args.repeats,
            "model": f"{args.blocks}x{args.filters}", "net_variant": args.net_variant,
            **device_record(dev), "rows": h.rows, "sum_of_parts": sums}


def main(argv: Optional[List[str]] = None) -> int:
    return finish(run(argv))


if __name__ == "__main__":
    sys.exit(main())
