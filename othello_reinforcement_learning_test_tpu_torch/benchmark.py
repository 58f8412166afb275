"""Engine benchmark: random-vs-random playouts and per-operation timings.

    python -m othello_reinforcement_learning_test_tpu_torch.benchmark [--device cpu]

Port of the root ``benchmark.py`` (which stays JAX-only), with the
reference's pass bar of 5,000 games/s. Two sections:

- the native C++ host engine (``ops/native.py``, one core): random
  playouts, then ``NativeBoard`` microbenchmarks;
- the batched tensor engine (``ops/bitboard.py``) on ``--device`` (CUDA by
  default, required; ``cpu`` on request), ``--batch`` games in lockstep to
  their end, in place of the JAX engine's section: the port's ``bench.py``
  random mode without the random-step kernel, the engine's own
  ``observe`` and ``step``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

from . import bench
from .ops import native
from .ops.bitboard import get_engine
from .utils.device import resolve_device

PASS_BAR = 5000  # games/s, the reference benchmark's bar


def bench_native(n_games: int) -> Optional[Dict]:
    if not native.available():
        print("native engine unavailable (no C++ toolchain)")
        return None
    print("=== native C++ engine (host, single core) ===")
    native.random_playout_benchmark(200, seed=0)  # warmup
    out = native.random_playout_benchmark(n_games, seed=1)
    print(
        f"games: {out['games']}  time: {out['seconds']:.3f}s  "
        f"games/sec: {out['games_per_sec']:,.0f}  "
        f"moves/sec: {out['moves_per_sec']:,.0f}  "
        f"avg moves: {out['moves'] / out['games']:.1f}"
    )
    print(
        f"black wins: {out['black_wins']}  white wins: {out['white_wins']}  "
        f"draws: {out['draws']}"
    )
    out["passed"] = out["games_per_sec"] >= PASS_BAR
    print(f"reference pass bar ({PASS_BAR:,} games/sec): {'PASS' if out['passed'] else 'FAIL'}")

    b = native.NativeBoard()
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        b.get_legal_moves_bits()
    t_legal = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        b.copy()
    t_copy = time.perf_counter() - t0
    out["legal_moves_per_sec"], out["copy_per_sec"] = n / t_legal, n / t_copy
    print(f"microbench ({n:,} calls): legal_moves {n / t_legal:,.0f}/s, "
          f"copy {n / t_copy:,.0f}/s")
    return out


def bench_batched(batch: int, repeats: int, device: str) -> Dict:
    dev = resolve_device(device)
    print(f"=== batched tensor engine on {dev} (batch {batch:,}) ===")
    args = argparse.Namespace(batch=batch, size=8, repeats=repeats, pallas=False)
    out = bench.bench_random(args, get_engine(8, "reference"), dev)
    print(f"games/sec: {out['value']:,.0f}   env-steps/sec: {out['env_steps_per_sec']:,.0f}  "
          f"(wall {out['wall_s']:.3f}s)")
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--games", type=int, default=10000, help="native playout count")
    parser.add_argument("--batch", type=int, default=65536, help="lockstep batch")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--device", choices=["auto", "cpu"], default="auto",
                        help="the batched section's device: auto = CUDA (required)")
    parser.add_argument("--skip-batched", action="store_true")
    return parser


def main(argv: Optional[list] = None) -> Dict:
    """Run both sections; returns ``{"native": ..., "batched": ...}``."""
    args = build_parser().parse_args(argv)
    out = {"native": bench_native(args.games), "batched": None}
    if not args.skip_batched:
        print()
        out["batched"] = bench_batched(args.batch, args.repeats, args.device)
    return out


if __name__ == "__main__":
    main()
