"""Network throughput benchmark of the port: boards/s across batch sizes.

    python -m othello_reinforcement_learning_test_tpu_torch.benchmark_model [--fused]

Port of the JAX package's ``benchmark_model.py`` (which stays JAX-only): the
same flags, rows and output lines, with ``--device`` (CUDA by default,
``cpu`` on request) in place of ``--platform``. It prints the per-call
dispatch overhead, measured with a null program of the same call structure
and subtracted from every row; the unfused eval forward at bf16 and f32
compute with the parameter count; with ``--fused``, one table per trunk
variant through ``FusedInference`` (``--block-games`` 0 is the variant's
default); and, on the card, device memory in use and at its peak.

Each timed call chains ``--chain`` forwards, each on ``x + carry`` (the
carry is the previous forward's output sum times 1e-9, so no forward can be
skipped), and ends in one host synchronisation. A batch that runs out of
device memory prints a "failed" row; any other error raises, so a broken
kernel cannot hide behind a row.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from .models.convert import from_jax_variables, init_train_variables
from .models.fused_resnet import PORTED_VARIANTS, FusedInference
from .models.resnet import OthelloResNet, param_count
from .utils.device import resolve_device

# benchmark_model.py's defaults
FUSED_VARIANTS = ["matmul9", "wide", "int8", "int8_xla"]
BATCHES = [1, 8, 32, 64, 128, 256, 1024, 4096]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--blocks", type=int, default=10)
    parser.add_argument("--filters", type=int, default=128)
    parser.add_argument("--device", default=None,
                        help="torch device: CUDA unless 'cpu' is asked for")
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--fused", action="store_true",
                        help="also measure the fused inference trunk kernels")
    parser.add_argument("--fused-variants", nargs="+", default=list(FUSED_VARIANTS),
                        help="trunk variants to measure with --fused: matmul9 (9 small "
                             "matmuls), wide (one (M,C)@(C,9C) matmul per conv), int8 "
                             "(int8 output shifts), int8_xla (plain int8), int8_m9, "
                             "int8_patch, int8_flat, int8_dx3, int8_dxcat, int8_bf16")
    parser.add_argument("--block-games", type=int, default=0,
                        help="games per activation-scale block (0 = per-variant default)")
    parser.add_argument("--chain", type=int, default=16,
                        help="forwards chained between two host synchronisations "
                             "(amortizes dispatch latency)")
    parser.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    return parser.parse_args(argv)


def _chained(forward: Callable, x: torch.Tensor, chain: int) -> float:
    """``chain`` forwards, each on ``x + carry``, then one host sync."""
    carry = torch.zeros((), dtype=torch.float32, device=x.device)
    outs = []
    for _ in range(chain):
        lp, val = forward(x + carry)
        out = lp.sum() + val.sum()
        carry = out * 1e-9
        outs.append(out)
    return float(torch.stack(outs).sum())


def run(argv: Optional[List[str]] = None) -> Dict:
    """Run the benchmark, print its lines and return them as a dict: the
    device, the dispatch overhead, the parameter count, one row per (table,
    batch) and the device memory."""
    args = parse_args(argv)
    for v in args.fused_variants if args.fused else ():
        if v not in PORTED_VARIANTS:
            raise ValueError(f"unknown fused variant {v!r}: one of {PORTED_VARIANTS}")
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    name = f"cuda:{dev.index or 0} ({torch.cuda.get_device_name(dev)})" if on_card else "cpu"
    print(f"device: {name}")
    result = {"device": name, "rows": []}

    # Fixed per-call overhead (launches + the host sync): a null program of
    # the same call structure, subtracted from every row
    def null(x):
        return torch.zeros((1, 1), device=x.device), (x.sum() * 1e-9)[None, None]

    xn = torch.zeros((8,), dtype=torch.float32, device=dev)
    _chained(null, xn, args.chain)
    null_reps = max(args.repeats, 5)
    t0 = time.perf_counter()
    for _ in range(null_reps):
        _chained(null, xn, args.chain)
    null_call = (time.perf_counter() - t0) / null_reps
    result["dispatch_ms"] = null_call * 1e3
    print(f"per-call dispatch overhead: {null_call * 1e3:.2f} ms (subtracted from each row)")

    def measure(table: str, b: int, forward: Callable) -> None:
        x = torch.zeros((b, 8, 8, 3), dtype=torch.float32, device=dev)
        row = {"table": table, "batch": b}
        try:
            _chained(forward, x, args.chain)  # warm-up (and kernel build)
            t0 = time.perf_counter()
            for _ in range(args.repeats):
                _chained(forward, x, args.chain)
            dt_raw = (time.perf_counter() - t0) / (args.repeats * args.chain)
        except torch.cuda.OutOfMemoryError as e:
            print(f"batch {b:5d}: failed ({type(e).__name__}: {e})")
            result["rows"].append({**row, "status": "failed"})
            return
        dt = dt_raw - null_call / args.chain
        row.update(raw_ms=dt_raw * 1e3, ms=dt * 1e3)
        if dt <= 0.1 * dt_raw:
            # the corrected time is inside the jitter of the dispatch
            # overhead: an on-device boards/s figure would be meaningless
            print(f"batch {b:5d}: dispatch-dominated ({dt_raw * 1e3:7.2f} ms raw, "
                  f"x{args.chain} chained; raise --chain to resolve)")
            result["rows"].append({**row, "status": "dispatch-dominated"})
            return
        print(f"batch {b:5d}: {b / dt:12,.0f} boards/sec ({dt * 1e3:7.2f} ms/batch on-device, "
              f"{dt_raw * 1e3:7.2f} ms raw, x{args.chain} chained)")
        result["rows"].append({**row, "status": "ok", "boards_per_s": b / dt})

    model = OthelloResNet(args.blocks, args.filters)
    model.load_state_dict(from_jax_variables(init_train_variables(args.blocks, args.filters, 0)))
    model = model.to(dev).eval()
    result["params"] = param_count(model)
    print(f"model: {args.blocks} blocks x {args.filters} filters ({result['params']:,} params)")
    for dtype_name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        print(f"--- compute dtype {dtype_name} ---")

        @torch.no_grad()
        def forward(x, dtype=dtype):
            return model(x, train=False, compute_dtype=dtype)

        for b in args.batches:
            measure(dtype_name, b, forward)

    if args.fused:
        for variant in args.fused_variants:
            fused = FusedInference(model, variant=variant, block_games=args.block_games)
            print(f"--- fused trunk variant {variant} "
                  f"(eval mode, block_games={fused.block_games}) ---")
            for b in args.batches:
                measure(variant, b, fused)

    if on_card:
        result["memory_mib"] = {"in_use": torch.cuda.memory_allocated(dev) / 2 ** 20,
                                "peak": torch.cuda.max_memory_allocated(dev) / 2 ** 20}
        print(f"device memory: in-use {result['memory_mib']['in_use']:.1f} MiB, "
              f"peak {result['memory_mib']['peak']:.1f} MiB")
    return result


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
