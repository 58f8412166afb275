#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Imports torch, numpy and the port package only (no JAX). Phases, one line
each as they finish:

1. device        card name and ``nvidia-smi`` name / power limit;
2. build         the trunk kernel built from ``csrc/`` with nvcc;
3. kernel_check  the ``int8_dx3`` trunk kernel against its plain PyTorch
                 version on the card, at B=1024 (bg 64) and B=24 (bg 8), on
                 stem outputs of real positions; 10x128 weights from a
                 numpy seed. Tolerance: bit-exact (the plain version repeats
                 the kernel's arithmetic); also FusedInference with the
                 kernel against the same forward with the plain trunk;
4. engine_check  random plies on CUDA and on the CPU: bit-identical boards;
5. selfplay      ``play_games`` at 10x128 with ``int8_dx3``: 1024 games,
                 25 simulations, c_puct 1.0, temperature threshold 15, root
                 noise on; trunk launches must be 20 per network forward and
                 the trajectories must be sane;
6. profile       one ply's search at B=1024 under torch.profiler: wall
                 time, device-busy time and idle share, time by kernel;
7. timing        the trunk kernel and its plain version at B=1024 (CUDA
                 events), the bound, launches per self-play ply.

Then one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and the
result line ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero; without CUDA it exits non-zero before any phase.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from othello_reinforcement_learning_test_tpu_torch.kernels import build
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dx3 import (
    block_size,
    trunk_int8_dx3,
    trunk_int8_dx3_plain,
)
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import FusedInference
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from othello_reinforcement_learning_test_tpu_torch.search import mcts
from othello_reinforcement_learning_test_tpu_torch.train.self_play import play_games

NUM_BLOCKS, NUM_FILTERS = 10, 128
GAMES, SIMS = 1024, 25
SEED = 0
# H100 SXM dense peaks (NVIDIA data sheet): int8 tensor cores, HBM3
INT8_OPS_PER_S = 1979e12
BYTES_PER_S = 3.35e12
TRUNK_SOURCE = "othello_reinforcement_learning_test_tpu_torch/csrc/trunk_int8_dx3.cu"
TRUNK_REPLACES = "othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:318"


def phase(phase_name: str, **fields) -> None:
    print(json.dumps({"phase": phase_name, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def random_positions(engine, n: int, plies: int, rng: np.random.Generator, device):
    """``n`` boards after ``plies`` uniform random legal moves (a finished
    game passes)."""
    boards = engine.initial_state((n,), device=device)
    for _ in range(plies):
        legal = engine.legal_actions(boards).cpu().numpy()
        action = np.array([rng.choice(np.flatnonzero(row)) for row in legal])
        boards, _ = engine.step(boards, torch.from_numpy(action).to(device))
    return boards


def profile_search(engine, net, boards) -> dict:
    """One self-play ply's search (SIMS simulations): its wall time, then,
    under torch.profiler, the device-busy time and the device time by
    kernel. The idle share is taken against the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    mcts.search(engine, net, boards, SIMS)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcts.search(engine, net, boards, SIMS)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mcts.search(engine, net, boards, SIMS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        return {"wall_ms": plain_wall_ms, "device_time": "not measured"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    trunk = sum(e.self_device_time_total for e in kernels if "conv_kernel" in e.key
                or "prepass_kernel" in e.key) / 1e3
    return {"wall_ms": plain_wall_ms, "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / plain_wall_ms, "trunk_kernel_ms": trunk,
            "device_launches_per_sim": sum(e.count for e in kernels) / SIMS,
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top]}


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trunk_bound_ms(batch: int, layers: int, channels: int) -> tuple:
    """Least time for one trunk forward on this card: int8 operations over
    the int8 tensor-core rate, bytes (bf16 in and out, int8 weights, f32
    scales and biases, each moved once) over the memory rate."""
    rows = batch * 64
    ops = layers * rows * channels * channels * 9 * 2
    nbytes = 2 * rows * channels * 2 + layers * (9 * channels * channels + 2 * channels * 4)
    t_ops, t_bytes = ops / INT8_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    # float32 references stay float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phase("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)

    built = build.build("trunk_int8_dx3")
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "smem" in ln]
    phase("build", seconds=round(built.seconds, 2), library=built.path.name, ptxas=ptxas)

    # 10x128 weights from a numpy seed, through the flax-layout converter
    model = OthelloResNet(NUM_BLOCKS, NUM_FILTERS)
    model.load_state_dict(from_jax_variables(init_numpy_variables(NUM_BLOCKS, NUM_FILTERS, SEED)))
    model = model.to(dev).eval()
    fused = FusedInference(model, variant="int8_dx3")
    layers = 2 * NUM_BLOCKS
    engine = get_engine(8, "reference")
    rng = np.random.default_rng(SEED)
    feats = engine.features(random_positions(engine, GAMES, 40, rng, dev))
    w, ws, b = fused.trunk_w, fused.trunk_scale, fused.trunk_bias
    max_abs_err = 0.0
    for batch in (GAMES, 24):
        h = fused.stem(feats[:batch])
        out_k = trunk_int8_dx3(h, w, ws, b)
        out_p = trunk_int8_dx3_plain(h, w, ws, b)
        torch.cuda.synchronize()
        diff = (out_k.float() - out_p.float()).abs()
        n_diff, err = int((diff != 0).sum()), float(diff.max())
        max_abs_err = max(max_abs_err, err)
        check(bool(torch.isfinite(out_k.float()).all()), "finite trunk output")
        bad_games = torch.nonzero(diff.reshape(batch, -1).amax(dim=1) > 0).flatten()
        phase("kernel_check", batch=batch, block_games=block_size(batch),
              differing=n_diff, of=out_k.numel(), max_abs_diff=err,
              games_differing=len(bad_games), first_games=bad_games[:8].tolist())
        check(n_diff == 0, f"trunk kernel == plain version at B={batch} "
              f"({n_diff} elements differ, max {err})")
    lp_k, v_k = fused(feats)
    lp_p, v_p = fused.heads(trunk_int8_dx3_plain(fused.stem(feats), w, ws, b))
    fused_lp = float((lp_k - lp_p).abs().max())
    fused_v = float((v_k - v_p).abs().max())
    phase("kernel_check", what="FusedInference kernel vs plain trunk",
          max_abs_diff_log_probs=fused_lp, max_abs_diff_value=fused_v)
    check(fused_lp == 0.0 and fused_v == 0.0, "FusedInference kernel == plain trunk")
    check(lp_k.shape == (GAMES, 65) and v_k.shape == (GAMES, 1), "output shapes")
    check(bool(torch.allclose(lp_k.exp().sum(-1), torch.ones(GAMES, device=dev), atol=1e-4)),
          "policy sums to 1")

    # engine: the same random plies on the card and on the CPU
    n_games, n_plies = 512, 130
    boards_c = engine.initial_state((n_games,), device=dev)
    boards_h = engine.initial_state((n_games,), device="cpu")
    for _ in range(n_plies):
        legal_c, term_c, win_c, f_c = engine.observe(boards_c, with_features=True)
        legal_h, term_h, win_h, f_h = engine.observe(boards_h, with_features=True)
        for a, h_ in ((legal_c, legal_h), (term_c, term_h), (win_c, win_h), (f_c, f_h)):
            check(torch.equal(a.cpu(), h_), "observe on CUDA == CPU")
        action = np.array([rng.choice(np.flatnonzero(row)) for row in legal_h.numpy()])
        act = torch.from_numpy(action)
        boards_c, valid_c = engine.step(boards_c, act.to(dev))
        boards_h, valid_h = engine.step(boards_h, act)
        check(torch.equal(valid_c.cpu(), valid_h), "step validity on CUDA == CPU")
        for a, h_ in zip(boards_c, boards_h):
            check(torch.equal(a.cpu(), h_), "boards on CUDA == CPU")
    check(bool(engine.is_terminal(boards_h).all()), "random games end")
    phase("engine_check", games=n_games, plies=n_plies, identical=True)

    # main path: self-play through the kernel
    forwards = 0

    def net(x):
        nonlocal forwards
        forwards += 1
        return fused(x)

    torch.cuda.synchronize()
    trunk_int8_dx3.launches = 0
    t0 = time.perf_counter()
    traj = play_games(engine, net, GAMES, SIMS, c_puct=1.0, temperature_threshold=15,
                      add_noise=True, seed=SEED, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = trunk_int8_dx3.launches
    mask = traj.mask
    plies = int(mask.any(dim=0).sum())
    check(launches > 0, "self-play launched the trunk kernel")
    check(launches == layers * forwards, f"launches {launches} == {layers} x forwards {forwards}")
    check(forwards == 1 + plies * SIMS, "one root forward, then one per simulation")
    check(not bool((mask[:, 1:] & ~mask[:, :-1]).any()), "masks are a prefix")
    check(plies < mask.shape[1], "every game finished")
    live_pi = traj.pi.sum(-1)[mask]
    check(bool(((live_pi - 1).abs() < 1e-5).all()), "pi sums to 1 on live plies")
    check(bool((traj.pi >= 0).all()) and bool((traj.pi[~mask] == 0).all()), "pi support")
    check(bool(torch.isin(traj.value, torch.tensor([-1.0, 0.0, 1.0], device=dev)).all()),
          "values in {-1, 0, 1}")
    check(bool((traj.value[~mask] == 0).all()), "values zero off the mask")
    total = traj.final_me_count + traj.final_opp_count
    check(bool((traj.final_me_count >= 0).all() and (total <= 64).all()), "stone counts <= 64")
    check(bool((traj.num_moves == mask.sum(1)).all()), "num_moves == live plies")
    wins = traj.winner_black.cpu()
    phase("selfplay", games=GAMES, simulations=SIMS, seconds=round(seconds, 3),
          games_per_s=round(GAMES / seconds, 3), plies=plies,
          game_plies=int(mask.sum()), forwards=forwards, trunk_launches=launches,
          black_wins=int((wins > 0).sum()), white_wins=int((wins < 0).sum()),
          draws=int((wins == 0).sum()))

    # timing at the main path's shape (B=1024)
    h = fused.stem(feats)
    kernel_ms = time_ms(lambda: trunk_int8_dx3(h, w, ws, b), reps=20)
    plain_ms = time_ms(lambda: trunk_int8_dx3_plain(h, w, ws, b), reps=3, warmup=1)
    forward_ms = time_ms(lambda: fused(feats), reps=20)
    bound_ms, bound_by = trunk_bound_ms(GAMES, layers, NUM_FILTERS)
    boards = random_positions(engine, GAMES, 20, rng, dev)
    phase("profile", what=f"one search at B={GAMES}, {SIMS} simulations, 20 plies in",
          **profile_search(engine, fused, boards))
    phase("timing", batch=GAMES, kernel_ms=kernel_ms, plain_ms=plain_ms,
          bound_ms=bound_ms, bound_by=bound_by, fused_forward_ms=forward_ms,
          launches_per_forward=layers, launches_per_ply=launches / plies,
          forward_share_of_selfplay=forward_ms * forwards / 1e3 / seconds)

    kernels = [{
        "name": "trunk_int8_dx3", "route": "cuda", "source": TRUNK_SOURCE,
        "replaces": TRUNK_REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]
    phase("done", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
