"""Split a self-play search into tree+env and forward on one device.

    python -m othello_reinforcement_learning_test_tpu_torch.profilers.profile_mcts \\
        [--batch 1024] [--sims 25] [--chain 4] [--net-variant int8] [--device cpu]

Port of the JAX package's ``scripts/profile_mcts.py`` (which stays
JAX-only): the same flags and defaults, with ``--device`` (CUDA unless
``cpu`` is asked for; no fallback) in place of ``--platform``, and
``--net-variant`` taking the plain eval forward (``xla``) and every
``FusedInference`` variant of the port. At B games, ``--sims`` simulations
and the trainer's initial weights at seed 0 it times three rows with
``profilers/common.py``'s harness, each call ``--chain`` searches long:

1. full search: ``--chain`` searches with root noise, each from the
   boards after the previous one's ``best_action`` (finished games kept);
2. tree+env only: the same searches through a constant network (zeros
   for the log-probs, 0.1 for the value, built on the device once);
3. forward only: ``(sims + 1) x chain`` forwards on the initial
   features.

It prints the JAX script's figures (ms a search, ms a forward-step, sims/s,
the tree+env share and the additive check) and each row's device-busy ms,
launches and host syncs a simulation. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch

from ..ops.bitboard import Board, get_engine
from ..search import mcts
from ..utils.device import resolve_device
from .common import Harness, device_record, finish
from .profile_mcts_parts import NET_VARIANTS, make_net


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--sims", type=int, default=25)
    ap.add_argument("--chain", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--filters", type=int, default=128)
    ap.add_argument("--net-variant", default="int8", choices=NET_VARIANTS)
    ap.add_argument("--device", default=None, help="torch device: CUDA unless 'cpu' is asked for")
    return ap.parse_args(argv)


def constant_net(num_actions: int, dev: torch.device) -> mcts.Net:
    """A free network: the same zeros and 0.1 for every batch size, built
    on the device at its first call for that size."""
    made = {}

    def net(x: torch.Tensor):
        m = x.shape[0]
        if m not in made:
            made[m] = (torch.zeros((m, num_actions), dtype=torch.float32, device=dev),
                       torch.full((m, 1), 0.1, dtype=torch.float32, device=dev))
        return made[m]

    return net


@torch.no_grad()
def run(argv: Optional[List[str]] = None) -> Dict:
    """Print the rows and return the JSON object."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    B, sims, K = args.batch, args.sims, args.chain
    engine = get_engine(8)
    net = make_net(args.blocks, args.filters, args.net_variant, dev)
    free = constant_net(engine.num_actions, dev)
    boards0 = engine.initial_state((B,), device=dev)
    free(boards0.me)  # the constants exist before the first timed call

    def chained(search_net):
        def chain():
            gen = torch.Generator(device=dev).manual_seed(1)
            boards = boards0
            for _ in range(K):
                res = mcts.search(engine, search_net, boards, sims, add_noise=True,
                                  generator=gen)
                act = mcts.best_action(res.visit_counts, res.legal)
                nxt, _ = engine.step(boards, act, pass_legal=res.legal[:, engine.pass_action])
                # finished games keep their boards
                boards = Board(*(torch.where(
                    res.root_terminal.view(-1, *[1] * (n.dim() - 1)), o, n)
                    for n, o in zip(nxt, boards)))
            return boards

        return chain

    _, _, _, feats0 = engine.observe(boards0, with_features=True)

    def forwards():
        for _ in range((sims + 1) * K):
            net(feats0)

    h = Harness(dev, 1, args.repeats)
    h.null()
    n_fwd = (sims + 1) * K
    full = h.time("full search", chained(net), forwards=n_fwd)
    tree = h.time("tree+env only", chained(free))
    fwd = h.time("forward only", forwards, forwards=n_fwd)

    def per_search(row):
        return row["wall_ms_net"]["best"] / K

    t_full, t_tree, t_fwd = per_search(full), per_search(tree), per_search(fwd)
    per_sim = {}
    for key, row in (("full", full), ("tree", tree), ("forward", fwd)):
        per_sim[key] = {f: (row[f] / (K * sims) if isinstance(row[f], (int, float)) else row[f])
                        for f in ("device_busy_ms", "launches", "syncs")}
        row["per_sim"] = per_sim[key]
    print(f"config: B={B} sims={sims} net={args.blocks}x{args.filters} "
          f"variant={args.net_variant} chain={K}")
    print(f"full search      : {t_full:8.2f} ms ({t_full / (sims + 1):.3f} ms/fwd-step, "
          f"{B * (sims + 1) / t_full:.0f}k sims/s)")
    print(f"tree+env only    : {t_tree:8.2f} ms ({t_tree / (sims + 1):.3f} ms/fwd-step)")
    print(f"forward only     : {t_fwd:8.2f} ms ({t_fwd / (sims + 1):.3f} ms/fwd-step, "
          f"{B * (sims + 1) / t_fwd:.0f}k boards/s)")
    share = 1 - t_fwd / t_full
    print(f"tree+env share   : {100 * share:.1f}% of full (additive check: tree {t_tree:.1f} + "
          f"fwd {t_fwd:.1f} = {t_tree + t_fwd:.1f} vs full {t_full:.1f})")
    print(f"ceiling fraction : {t_fwd / t_full * 100:.1f}% of forward-only throughput "
          f"(target >=85%)")
    for key, figs in per_sim.items():
        print(f"a simulation, {key:8s}: device busy {figs['device_busy_ms']}, "
              f"launches {figs['launches']}, syncs {figs['syncs']}")
    return {"profiler": "profile_mcts", "batch": B, "sims": sims, "chain": K,
            "repeats": args.repeats, "model": f"{args.blocks}x{args.filters}",
            "net_variant": args.net_variant, **device_record(dev), "rows": h.rows,
            "ms_per_search": {"full": t_full, "tree_env": t_tree, "forward": t_fwd},
            "ms_per_forward_step": {"full": t_full / (sims + 1), "tree_env": t_tree / (sims + 1),
                                    "forward": t_fwd / (sims + 1)},
            "ksims_per_s": B * (sims + 1) / t_full, "tree_env_share": share,
            "additive_ms": t_tree + t_fwd, "ceiling_fraction": t_fwd / t_full,
            "per_sim": per_sim}


def main(argv: Optional[List[str]] = None) -> int:
    return finish(run(argv))


if __name__ == "__main__":
    sys.exit(main())
