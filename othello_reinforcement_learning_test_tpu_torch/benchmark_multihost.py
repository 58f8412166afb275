"""Multi-process weak-scaling benchmark of self-play.

    python -m othello_reinforcement_learning_test_tpu_torch.benchmark_multihost --processes 1 2

Port of the root ``benchmark_multihost.py`` (which stays JAX-only), with its
flags, JSON lines and keys. For each N of ``--processes`` it spawns N
processes joined in a ``torch.distributed`` process group (the bring-up of
``cli train --coordinator``), each playing a fixed ``--games-per-process``
of MCTS self-play, and reports the aggregate games/s and the weak-scaling
efficiency ``thpt(N) / (N * thpt(1))``:

- ``--design global``: each rank plays its shard of the global batch from
  one seed (``play_games(shard=...)``), as the trainer's ``global`` design;
- ``--design local``: each rank plays its own games from a per-rank seed,
  then the trajectories are all-gathered (the trainer's ``local`` design);
  ``assembly_ms_per_iter`` times that gather.

Each worker is pinned to one core and one torch thread, so N=1 -> N=k
compares 1 core with k cores. ``--device auto`` is CUDA (NCCL, one card a
process, ``cuda:{rank % cards}``), ``cpu`` the CPU (gloo).

Output: one JSON line per N, then ``{"metric":
"multihost_weak_scaling_efficiency", ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(pid: int, nprocs: int, port: int, outdir: str, games: int, sims: int, blocks: int,
           filters: int, cond_interval: int, design: str = "global",
           device: str = "auto") -> None:
    # constant resources a process: one core and one thread each, so that
    # co-located workers do not oversubscribe the cores
    try:
        ncores = len(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {pid % ncores})
    except (AttributeError, OSError):
        pass  # not Linux: unpinned
    import torch

    torch.set_num_threads(1)
    from .models.convert import from_jax_variables, init_train_variables
    from .models.resnet import OthelloResNet
    from .ops.bitboard import get_engine
    from .parallel import mesh
    from .train.self_play import auto_cond_interval, play_games
    from .train.trainer import apply_eval

    if nprocs > 1:
        mesh.initialize_distributed(f"127.0.0.1:{port}", nprocs, pid, device=device)
    dev = mesh.local_device(device)
    if cond_interval <= 0:  # 0 = auto, as the trainer resolves it
        cond_interval = auto_cond_interval()
        if pid == 0:
            print(f"cond_interval auto-selected: {cond_interval}", flush=True)

    engine = get_engine(8, "reference")
    model = OthelloResNet(blocks, filters)
    model.load_state_dict(from_jax_variables(init_train_variables(blocks, filters, 0)))
    net = apply_eval(model.to(dev))
    total_games = games * nprocs  # weak scaling: a fixed load a process
    assembly = {"bytes": 0, "ms": 0.0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(seed: int) -> int:
        if design == "global":
            traj = play_games(engine, net, total_games, sims, seed=seed, device=dev,
                              cond_interval=cond_interval, shard=(pid, nprocs))
        else:
            traj = play_games(engine, net, games, sims, seed=mesh.fold_in_process(seed),
                              device=dev, cond_interval=cond_interval)
            sync()
            t0 = time.perf_counter()
            assembly["bytes"] = sum(t.numel() * t.element_size() for t in traj)
            traj = mesh.all_gather_leading(traj)
            sync()
            assembly["ms"] = (time.perf_counter() - t0) * 1e3
        # the global number of moves: a sum over the ranks
        moves = traj.num_moves.sum().to(torch.int64)
        if design == "global":
            moves = mesh.all_reduce_sum(moves) if nprocs > 1 else moves
        return int(moves)

    run(0)  # warm-up
    mesh.barrier()
    t0 = time.perf_counter()
    moves = run(1)
    mesh.barrier()
    dt = time.perf_counter() - t0
    if pid == 0:
        with open(os.path.join(outdir, f"n{nprocs}.json"), "w") as f:
            json.dump({"processes": nprocs, "design": design, "games": total_games,
                       "games_per_s": total_games / dt, "env_steps_per_s": moves / dt,
                       "wall_s": dt, "assembly_ms_per_iter": round(assembly["ms"], 2),
                       "assembly_bytes_per_process": assembly["bytes"]}, f)
    if nprocs > 1:
        torch.distributed.destroy_process_group()


def measure_once(nprocs: int, args, outdir: str) -> dict:
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", __spec__.name, "--worker", str(pid), str(nprocs), str(port),
         outdir, str(args.games_per_process), str(args.simulations), str(args.blocks),
         str(args.filters), str(args.cond_interval), args.design, args.device],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for pid in range(nprocs)]
    try:
        for p in procs:
            if p.wait(timeout=args.timeout) != 0:
                raise RuntimeError(f"worker failed (N={nprocs})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(os.path.join(outdir, f"n{nprocs}.json")) as f:
        return json.load(f)


def measure(nprocs: int, args, outdir: str) -> dict:
    """The median throughput of ``--repeats`` runs (a noisy host swings the
    N=1 baseline, which the efficiency ratio amplifies)."""
    runs = sorted((measure_once(nprocs, args, outdir) for _ in range(args.repeats)),
                  key=lambda r: r["games_per_s"])
    med = runs[len(runs) // 2]
    med["repeats"] = args.repeats
    med["games_per_s_all"] = [round(r["games_per_s"], 2) for r in runs]
    return med


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--processes", type=int, nargs="+", default=[1, 2])
    parser.add_argument("--games-per-process", type=int, default=32)
    parser.add_argument("--simulations", type=int, default=8)
    parser.add_argument("--blocks", type=int, default=2)
    parser.add_argument("--filters", type=int, default=32)
    parser.add_argument("--timeout", type=int, default=1200)
    parser.add_argument("--repeats", type=int, default=3,
                        help="runs per N; the median throughput is used")
    parser.add_argument("--cond-interval", type=int, default=0,
                        help="test liveness every k plies and walk steps (the same "
                             "results for any k); 0 = auto, as the trainer resolves it")
    parser.add_argument("--design", choices=["global", "local"], default="global",
                        help="'global': each rank plays its shard of one seeded batch; "
                             "'local': each rank its own games, then all-gathered")
    parser.add_argument("--device", choices=["auto", "cpu"], default="auto",
                        help="auto = CUDA (NCCL, one card a process); cpu = the CPU (gloo)")
    parser.add_argument("--worker", nargs=11, default=None,
                        help="(internal) pid nprocs port outdir games sims blocks filters "
                             "cond_interval design device")
    return parser


def main(argv: Optional[list] = None) -> dict:
    args = build_parser().parse_args(argv)
    if args.worker:
        w = args.worker
        worker(int(w[0]), int(w[1]), int(w[2]), w[3], int(w[4]), int(w[5]), int(w[6]),
               int(w[7]), int(w[8]), w[9], w[10])
        return {}

    results = {}
    with tempfile.TemporaryDirectory() as outdir:
        for n in args.processes:
            results[n] = measure(n, args, outdir)
            print(json.dumps(results[n]), flush=True)
    base = min(results)
    base_thpt = results[base]["games_per_s"] / base
    for n in sorted(results):
        results[n]["efficiency_vs_linear"] = results[n]["games_per_s"] / (n * base_thpt)
    top = max(results)
    summary = {"metric": "multihost_weak_scaling_efficiency",
               "value": round(results[top]["efficiency_vs_linear"], 3),
               "unit": f"fraction of linear at N={top}",
               "per_n": {str(n): round(r["games_per_s"], 2) for n, r in results.items()},
               "note": "processes on one machine; on CUDA one card a process"}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
