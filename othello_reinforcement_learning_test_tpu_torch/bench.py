"""Headline benchmark of the port on one card. Prints exactly one JSON line.

    python -m othello_reinforcement_learning_test_tpu_torch.bench [--mode all]

Port of the JAX package's ``bench.py`` (which stays JAX-only): the same
modes, flags, per-mode defaults and JSON keys, with ``--device`` (CUDA by
default, ``cpu`` on request) in place of ``--platform``. There is no
fallback: without CUDA the bench raises unless ``--device cpu`` is given.

Modes:
  random — batched random self-play to the end of every game, the
      reference's ``benchmark.py`` workload. With ``--pallas`` (on by
      default on the card, refused on the CPU) every ply is one launch of
      the random-step kernel (``ops/fused_step.py``); without it, the
      engine's ``observe`` and ``step`` with uniform sampling over the legal
      actions. ``vs_baseline`` is against the reference's 10,000 games/s.
  mcts — batched AlphaZero self-play (``play_games``) from the trainer's
      initial weights, through ``FusedInference(--net-variant)`` or, for
      ``xla``, the plain eval forward. ``vs_baseline`` is against the
      reference's 100 games per 300 s.
  train — one steady-state training iteration (after a warm-up one) in the
      ``default_8x8`` regime; ``vs_baseline`` is the reference's 300 s over
      the iteration's seconds.
  all (default) — the three in turn, one combined line; ``mcts`` runs
      ``int8_dx3`` on the card unless ``--net-variant`` is given.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from .models.convert import from_jax_variables, init_train_variables
from .models.fused_resnet import FusedInference
from .models.resnet import OthelloResNet
from .ops.bitboard import Board, OthelloEngine, get_engine
from .ops.fused_step import pack_boards, play_random_games
from .train.self_play import play_games
from .train.trainer import AlphaZeroTrainer, _sync, apply_eval
from .utils.config import load_config
from .utils.device import resolve_device

NET_VARIANTS = ("xla", "matmul9", "int8", "int8_dx3", "int8_xla")  # bench.py's choices


def bench_random(args, engine: OthelloEngine, dev: torch.device) -> Dict:
    if args.pallas:
        return bench_random_kernel(args, engine, dev)
    B = args.batch
    T = 2 * args.size * args.size + 4

    def play(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        s = engine.initial_state((B,), device=dev)
        legal, term, _ = engine.observe(s)
        steps = torch.zeros((), dtype=torch.int64, device=dev)
        t = 0
        while bool((~term).any()) and t < T:
            # one observation (2 flood passes) + one flip resolution per step
            live = ~term
            u = torch.rand(legal.shape, generator=gen, device=dev)
            a = torch.argmax(torch.where(legal, u, -1.0), dim=-1)  # uniform over legal
            nxt, _ = engine.step(s, a, pass_legal=legal[:, engine.pass_action])
            s = Board(*(torch.where(live, n, o) for n, o in zip(nxt, s)))
            legal, term, _ = engine.observe(s)
            steps += live.sum()
            t += 1
        return int(steps), float(s.move_count.to(torch.float32).mean())

    play(0)
    best_gps, best = 0.0, None
    for r in range(args.repeats):
        t0 = time.perf_counter()
        steps, avg_moves = play(r + 1)
        dt = time.perf_counter() - t0
        if B / dt > best_gps:
            best_gps, best = B / dt, (dt, steps, avg_moves)
    dt, env_steps, avg_moves = best
    return {
        "metric": "selfplay_games_per_sec",
        "value": round(best_gps, 1),
        "unit": "games/s",
        "vs_baseline": round(best_gps / 10000.0, 3),
        "env_steps_per_sec": round(env_steps / dt, 1),
        "batch": B,
        "avg_moves": round(avg_moves, 2),
        "wall_s": round(dt, 4),
    }


def bench_random_kernel(args, engine: OthelloEngine, dev: torch.device) -> Dict:
    """Random self-play through the random-step kernel, one launch a ply."""
    B = args.batch
    s = engine.initial_state((B,), device=dev)
    packed = pack_boards(s.me, s.opp)

    def run(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        _, steps, _ = play_random_games(packed, gen, max_plies=2 * args.size ** 2 + 4,
                                        size=engine.size, rules=engine.rules)
        return steps

    run(0)
    best_gps, best = 0.0, None
    for r in range(args.repeats):
        t0 = time.perf_counter()
        steps = run(r + 1)
        dt = time.perf_counter() - t0
        if B / dt > best_gps:
            best_gps, best = B / dt, (dt, steps)
    dt, env_steps = best
    return {
        "metric": "selfplay_games_per_sec",
        "value": round(best_gps, 1),
        "unit": "games/s",
        "vs_baseline": round(best_gps / 10000.0, 3),
        "env_steps_per_sec": round(env_steps / dt, 1),
        "batch": B,
        "kernel": "cuda_random_step",
        "wall_s": round(dt, 4),
    }


def bench_mcts(args, engine: OthelloEngine, dev: torch.device) -> Dict:
    B, sims = args.batch, args.simulations
    model = OthelloResNet(args.blocks, args.filters, args.size)
    model.load_state_dict(from_jax_variables(
        init_train_variables(args.blocks, args.filters, 0, args.size)))
    model = model.to(dev).eval()
    net = apply_eval(model) if args.net_variant == "xla" else FusedInference(model, args.net_variant)

    def run(seed: int):
        traj = play_games(engine, net, B, sims, temperature_threshold=15, seed=seed, device=dev)
        return int(traj.num_moves.sum()), int(traj.num_moves.max())

    run(0)
    best = None
    for r in range(args.repeats):
        t0 = time.perf_counter()
        total_moves, max_moves = run(r + 1)
        dt = time.perf_counter() - t0
        if best is None or B / dt > best[0]:
            best = (B / dt, dt, total_moves, max_moves)
    gps, dt, total_moves, max_moves = best
    env_steps = total_moves / dt
    return {
        "metric": "mcts_selfplay_games_per_sec",
        "value": round(gps, 2),
        "unit": "games/s",
        # the reference trains 100 games an iteration in about 300 s
        "vs_baseline": round(gps / (100.0 / 300.0), 1),
        "env_steps_per_sec": round(env_steps, 1),
        "nn_sims_per_sec": round(env_steps * sims, 1),
        "batch": B,
        "num_simulations": sims,
        "model": f"{args.blocks}x{args.filters}",
        "net_variant": args.net_variant,
        "wall_s": round(dt, 3),
        # the lockstep loop runs max_moves plies while throughput counts the
        # mean: the gap is the tail's waste
        "max_moves": max_moves,
        "avg_moves": round(total_moves / B, 1),
    }


def bench_train(args, engine: OthelloEngine, dev: torch.device) -> Dict:
    cfg = load_config()
    cfg["game"]["size"] = args.size
    cfg["training"].update(
        num_iterations=1,
        self_play_episodes_per_iter=args.batch,
        batch_size=256,
        train_epochs_per_iter=10,
        replay_buffer_size=100_000,
        checkpoint_interval=10_000,
    )
    cfg["model"].update(num_blocks=args.blocks, num_filters=args.filters, board_size=args.size)
    cfg["mcts"]["num_simulations"] = args.simulations
    if args.net_variant != "xla":
        cfg["system"]["self_play_net_variant"] = args.net_variant
    with tempfile.TemporaryDirectory() as d:
        cfg["paths"]["checkpoint_dir"] = d + "/m"
        cfg["paths"]["log_dir"] = d + "/l"
        trainer = AlphaZeroTrainer(cfg, engine=engine, log_cb=None, device=dev)
        try:
            # warm-up iteration, then a steady-state one (self-play -> buffer
            # -> 10 SGD steps; the reference's ~300 s is a steady-state figure)
            trainer._train_iteration(0, args.batch, 3, [], [])
            _sync(dev)
            t0 = time.perf_counter()
            trainer._train_iteration(1, args.batch, 3, [], [])
            _sync(dev)
            dt = time.perf_counter() - t0
        finally:
            trainer.close()
    return {
        "metric": "train_iteration_seconds",
        "value": round(dt, 3),
        "unit": "s/iteration",
        # the reference: about 300 s an iteration on an RTX 4050
        "vs_baseline": round(300.0 / dt, 1),
        "episodes": args.batch,
        "num_simulations": args.simulations,
        "model": f"{args.blocks}x{args.filters}",
        "net_variant": args.net_variant,
    }


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mode", choices=["all", "random", "mcts", "train"], default="all",
                        help="'all' (default) runs random, mcts and train and prints one "
                             "combined JSON line")
    parser.add_argument("--batch", type=int, default=None,
                        help="games in lockstep (defaults per mode)")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--device", default=None,
                        help="torch device: CUDA unless 'cpu' is asked for")
    parser.add_argument("--size", type=int, default=8)
    parser.add_argument("--simulations", type=int, default=25)
    parser.add_argument("--net-variant", choices=NET_VARIANTS, default=None,
                        help="mcts and train modes: the self-play network (default xla, "
                             "the plain eval forward; int8_dx3 for mcts in 'all' on the card)")
    parser.add_argument("--blocks", type=int, default=10)
    parser.add_argument("--filters", type=int, default=128)
    parser.add_argument("--pallas", action=argparse.BooleanOptionalAction, default=None,
                        help="random mode: one random-step kernel launch per ply (default: "
                             "on the card; refused on the CPU)")
    return parser.parse_args(argv)


def run(argv: Optional[List[str]] = None) -> Dict:
    """Run the bench and return its JSON object."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if args.pallas is None:
        args.pallas = on_card
    if args.pallas and not on_card:
        raise ValueError("--pallas runs the random-step CUDA kernel; it needs the card")
    engine = get_engine(args.size, "reference")

    def resolve(mode: str, variant_default: str) -> argparse.Namespace:
        a = copy.copy(args)
        a.mode = mode
        if a.batch is None:
            a.batch = {"random": 4194304 if a.pallas else 262144, "mcts": 1024,
                       "train": 100}[mode]
        if a.net_variant is None:
            a.net_variant = variant_default
        return a

    fns = {"random": bench_random, "mcts": bench_mcts, "train": bench_train}
    if args.mode == "all":
        modes = {mode: fns[mode](resolve(mode, "int8_dx3" if mode == "mcts" and on_card
                                         else "xla"), engine, dev)
                 for mode in ("random", "mcts", "train")}
        # the headline is the training workload's self-play games/s
        out = {
            "metric": "alphazero_suite_mcts_games_per_sec",
            "value": modes["mcts"]["value"],
            "unit": "games/s",
            "vs_baseline": modes["mcts"]["vs_baseline"],
            "modes": modes,
        }
    else:
        out = fns[args.mode](resolve(args.mode, "xla"), engine, dev)
    out["device"] = f"cuda:{dev.index or 0} ({torch.cuda.get_device_name(dev)})" if on_card else "cpu"
    return out


def main(argv: Optional[List[str]] = None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
