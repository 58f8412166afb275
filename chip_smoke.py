#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Imports torch, numpy and the port package only (no JAX). Phases, one line
each as they finish:

1. device        card name and ``nvidia-smi`` name / power limit;
2. build         the nine kernels (``trunk_int8_dx3``, ``trunk_matmul9``,
                 ``trunk_int8``, ``random_step``, ``trunk_wide``,
                 ``trunk_int8_m9``, ``trunk_int8_patch``,
                 ``trunk_int8_flat``, ``trunk_int8_dxcat``) built from
                 ``csrc/`` with nvcc, the trunks at 8x8 boards and 128
                 channels, and beside them the 30 libraries of phase
                 ``shapes`` (each trunk source is a template on the board
                 side and width, one library a shape), all in parallel;
                 each with its seconds; ptxas registers and
                 shared memory; for ``trunk_matmul9`` and ``trunk_wide``
                 their HGMMA (bf16 wgmma) count from ``cuobjdump -sass``,
                 for ``trunk_int8_dx3``, ``trunk_int8``, ``trunk_int8_m9``,
                 ``trunk_int8_patch``, ``trunk_int8_flat`` and
                 ``trunk_int8_dxcat`` their IGMMA (integer wgmma) count;
                 none may be 0;
3. kernel_check  the ``int8_dx3`` trunk kernel against its plain PyTorch
                 version on the card, at B=1024 (bg 64), B=1040 (bg 16,
                 more games than two a CTA), B=267 (bg 1, an odd count),
                 B=24 (bg 8), B=3 and B=1 (bg 1), on
                 stem outputs of real positions (B=1040 repeats the first
                 16); 10x128 weights from a
                 numpy seed. Tolerance: bit-exact (the plain version repeats
                 the kernel's arithmetic); also FusedInference with the
                 kernel against the same forward with the plain trunk.
                 Then the ``matmul9`` kernel on the same inputs (B=1024,
                 267, 24, 3 and 1), with the
                 same weights and with the trainer's initial (flax-init)
                 weights: the whole trunk equal bit for bit to its 20 convs
                 launched one by one (the kernel sums in a fixed order);
                 each of the 20 convs against the plain conv on the same
                 input, within PyTorch's bf16 default (rtol 1.6e-2, atol
                 1e-5) plus the f32 summation bound of ``sum_error_bound``
                 (only the order of the f32 sums differs, and near zero
                 that alone exceeds 1e-5); the whole trunk's differences
                 printed, beside those between the plain version on the
                 card and two other orders of its f32 sums (on the CPU; on
                 the card with taps and input channels reversed);
                 FusedInference with the kernel against the plain trunk at
                 the JAX package's ``matmul9`` bar (probs atol 0.03, value
                 atol 0.05) on the flax-init weights (the He-normal tower's
                 policy is so sharp that the summation order moves it by
                 whole moves: printed, not checked).
                 Then the ``trunk_int8`` kernel, both ``stage_bf16``
                 settings, against its plain version at B=1024, 1040 (bg
                 16), 267, 24 (bg 8), 3 and 1 on the same stem outputs:
                 bit-exact; and
                 FusedInference(int8) with the kernel against the plain
                 trunk. Then ``trunk_wide`` on both weight sets as
                 ``matmul9`` (batches 1024, 267, 24, 3, 1): the trunk equal bit for
                 bit to its 20 convs, each conv within the bf16 default plus
                 ``sum_error_bound`` plus one bf16 ulp of each tap's product
                 (``trunk_wide.conv_bound``: the tensor cores' order of each
                 tap's f32 dot can move its bf16 rounding by an ulp), and
                 FusedInference(wide) at probs 0.03 / value 0.05 on the
                 flax-init weights. Then ``trunk_int8_m9``,
                 ``trunk_int8_patch``, ``trunk_int8_flat`` and
                 ``trunk_int8_dxcat`` against their plain version (the plain
                 ``int8_dx3`` trunk on the kernel's weights) bit for bit:
                 ``m9``, ``patch`` and ``flat`` (the int8 conv body at bg
                 32) at B=1024, 1040, 267, 24, 3 and 1;
                 ``dxcat`` (the whole trunk in one launch) at its gated
                 path's B=64 (bg 64) and 40 (bg 8) and at 1024, 1040, 267,
                 24, 3 and 1, then 200 forwards each at B=64 and 40, every
                 one equal to the plain output (a missing fence across its
                 grid barrier would flip a rare int8 code); launches 20 a
                 forward (``dxcat``: 1); FusedInference with each against
                 the plain trunk: equal; then ``m9``, ``patch`` and
                 ``flat`` taking turns on one weight tensor at B=64, its
                 contents rewritten in place after the first round (each
                 library caches its weight maps by address): equal to
                 the plain version. Then ``random_step`` against ``random_step_plain``
                 on the card, fed the same words, every ply of 4,096 games
                 to their end for sizes 8, 6 and 4 under both rule sets,
                 then of the bench's 4,194,304 games at 8x8: bit-exact
                 boards and ``live``; and ``play_random_games``
                 through the kernel against the plain loop on the CPU fed
                 the same words (16,384 games): equal final boards, steps
                 and plies;
4. engine_check  random plies on CUDA and on the CPU: bit-identical boards;
5. search_check  ``play_games`` on the card and on the CPU with a
                 deterministic stub network (its log-softmax taken in
                 float64: in float32 the card's differs from the CPU's by an
                 ulp), 128 games, 8 simulations, no root noise, temperature
                 threshold 0: the stub's outputs and every trajectory field
                 (boards, pi targets, outcomes, masks) bit-identical;
   arena_check   ``Arena.play_matches`` on the card and on the CPU, 64
                 games each at ``opening_random_plies=0``: Greedy vs Greedy,
                 and ``MCTSPlayer`` on the stub network (8 simulations) vs
                 Greedy: every game's winner, scores and move count
                 identical; then ``NativeMinimaxPlayer`` (depth 2, the
                 port's g++ build of ``csrc/othello_native.cpp``) vs Greedy;
6. selfplay      ``play_games`` at 10x128 with ``int8_dx3``: 1024 games,
                 25 simulations, c_puct 1.0, temperature threshold 15, root
                 noise on; trunk launches must be 20 per network forward and
                 the trajectories must be sane;
7. train_step_check  one SGD step at 10x128 from the trainer's initial
                 weights, f32 compute, TF32 off, on one fixed batch of 1024
                 real positions, on the card and on the CPU: loss rtol
                 1e-4; every updated parameter and BatchNorm statistic rtol
                 1e-4, atol 1e-6 (sums in other orders; the step moves a
                 parameter by lr * grad, so f32's relative error in the
                 gradient, which 20 BatchNorm backward passes raise to about
                 1e-3 in some leaves, enters scaled by lr 0.006); each
                 leaf's update error card vs CPU (relative L2) is printed;
8. train         one ``AlphaZeroTrainer`` iteration at the flagship recipe
                 (``configs/run_flagship_r5.yaml``) with self-play through
                 ``matmul9`` and a checkpoint: launches = 20 x network
                 forwards, buffer fill = valid plies, 24 finite losses,
                 parameters moved, the checkpoint reloads exactly;
   gating        one gated ``AlphaZeroTrainer`` iteration at 10x128 through
                 ``int8_dxcat``, the ``configs/strong_8x8.yaml`` recipe cut
                 to one batch of 64 games of 25 simulations, 4 SGD steps and
                 gating and a checkpoint at iteration 1: ``trunk_int8_dxcat``
                 launched once a forward (self-play + gate match), 40 gate
                 games, the decision logged and written as its two scalars,
                 best equal to the candidate if adopted and unchanged if
                 not, the checkpoint holding best and reloading it exactly;
   cli           the port's user entry points in process, writing only
                 under the git-ignored ``_build/``: ``configs/run_flagship_r5.yaml``
                 read with the port's ``load_config`` (no pyyaml), cut in
                 the same YAML subset (10x128, ``int8_dx3``, its lr and
                 c_puct; 256 games of 16 simulations, 4 SGD steps at batch
                 1024, 2 iterations with a checkpoint each, no
                 self-healing); ``cli train --config``: ``trunk_int8_dx3``
                 launched 20 x network forwards (> 0), no other trunk, no
                 self-heal line, the checkpoints written; the file raised to
                 3 iterations and ``train --resume latest``: starts at
                 iteration 3, ends with ``final_model`` at 3; ``eval
                 --games 8 --simulations 8 --minimax-depth 2
                 --save-results``: Random, Greedy and the alpha-beta engine
                 each with a result and no error; ``play`` with scripted
                 input (the first legal move) to game over; ``export`` as
                 ``reference-pt``, ``torchscript`` and ``stablehlo`` (the
                 ``torch.export`` program) at batch 256, each reloaded on
                 the card and run on 256 real positions against the
                 checkpoint's network in eval mode at f32: ``reference-pt``
                 bit for bit, the other two within 1e-5; the port's
                 ``benchmark.py``, both sections (2,000 native playouts
                 against the 5,000 games/s bar, 4,096 games on the card);
                 the seconds of each step;
   distributed   data parallelism (``parallel/mesh.py``): an NCCL process
                 group of world size 1 on the card (backend ``nccl``;
                 ``all_gather_leading`` of a trajectory, the gradient
                 all-reduce, the BatchNorm moment all-reduce and its
                 gradient, ``broadcast``, each equal to its input); then two
                 ranks on the one card over gloo (NCCL refuses two ranks on
                 one card), two processes of this script
                 (``--distributed-rank``), each running ``cli train
                 --coordinator`` on ``configs/run_flagship_r5.yaml`` cut to
                 128 games a rank of 8 simulations, 4 SGD steps at batch 1024
                 (512 a rank), 2 iterations with a checkpoint (rank 0 writes),
                 through ``int8_dx3``; then in the same group one gated
                 ``STRONG`` iteration through ``int8_dxcat`` (32 games a rank,
                 a 40-game gate match, 20 a rank); then one f32 SGD step at
                 10x128 on its half of 1024 positions. Checks: each rank's
                 trunk launches = 20 x its forwards (``int8_dxcat``: 1 x), no
                 other trunk, no self-heal line; both ranks end with equal
                 parameter and buffer digests and the same gate decision and
                 record; the 2-rank step equal to the single-process
                 full-batch step here (loss rtol 1e-4; parameters and
                 statistics rtol 1e-4, atol 1e-6, as ``train_step_check``);
                 each rank's seconds of self-play, SGD, gate match and
                 checkpoint;
   frontends     the web session, the stdlib REST server and the Tk app
                 (``apps/``) on the card, writing only under the git-ignored
                 ``_build/chip_smoke_frontends``; no kernel is on this path
                 (the players run the plain bf16 forward, ``apply_eval``),
                 and none may launch. (a) A ``GameManager`` on the card and
                 one on the CPU, each with an ``MCTSPlayer`` on the stub
                 network at 16 simulations, through one whole game (human
                 moves drawn from numpy, every other ply an AI move, one
                 undo, one hint): every ``state_dict()`` and the hint
                 identical. (b) The trained flagship r5 network
                 (``..._torch/trained/``, its file and config sidecar),
                 the stdlib server on a free port over a CUDA session, and
                 the JS client's sequence over HTTP: ``/`` and its scripts,
                 the model list (holding the checkpoint), load-model,
                 simulations 100, a whole game (human moves, AI moves
                 polled through ai-status every 0.05 s, passes included),
                 a hint every 10 plies, one undo, one AI move at 500
                 simulations; checks: every AI move legal, 1 + simulations
                 forwards a move, the game over, the network and the board
                 on the card, the final board equal to the CPU engine
                 replaying the actions, hints legal and in 0-100; prints the
                 AI move's seconds (first, median, max at 100 simulations;
                 at 500), the hint's, the median ``GET /api/game/state``
                 ms, the CUDA MiB allocated at the game's start and at its
                 peak; then a 25-simulation search at B=1 through the
                 profilers' harness (wall, device busy, idle share, launches
                 a simulation) and the network's forward at B=1. (c) The port's ``OthelloApp`` on the card under
                 ``tests/fake_tk.py`` with the checkpoint: a click, the
                 AI's reply through its thread and ``root.after``, a hint;
                 the draw operations and button states checked;
   trained       the repo's trained networks (``..._torch/trained/``:
                 flagship r5 and 500iter, 10x128, converted from the JAX
                 package's checkpoints) on the card, on 1024 positions after
                 20 random plies: each network's kernels at the gates of
                 the seeded weights (``int8_dx3``, ``trunk_int8`` both
                 settings, ``int8_m9``, ``_patch``, ``_flat``, ``_dxcat``
                 bit for bit at B=1024 and 64; ``matmul9`` and ``wide``
                 equal to their 20 convs, each conv within its bar, the
                 forward within probs 0.03 / value 0.05 or, past that,
                 twice the largest drift of the plain version's two
                 witnesses, other correct f32 orders); each of the ten
                 variants' forward against the plain bf16 forward at
                 B=1024 and 64: top legal move agreement >= 0.9, value
                 correlation > 0.95 (the JAX package's bars for quantized
                 inference), its kernel launched 20 times a forward
                 (``int8_dxcat`` once, ``int8_xla`` none); flagship r5 as
                 ``MCTSPlayer`` (bf16, 25 simulations) against Greedy, 50
                 games at 4 random opening plies through
                 ``Arena.play_matches``, the protocol of its JAX record
                 (46-4 at 100 simulations, which ``benchmark_ai`` plays at
                 its defaults) at a quarter of its simulations: at least
                 26 wins, a majority; then ``cli train`` on
                 ``configs/run_500iter_prioritized.yaml`` and
                 ``run_500iter_symaug.yaml`` read with the port's YAML
                 reader and cut to one iteration of 64 games at 8
                 simulations through ``int8_dx3``, 2 SGD steps and a
                 checkpoint: launches 20 x forwards, the reloaded
                 prioritized buffer's priorities finite, positive and moved,
                 augmentation on under the standard rules;
   learn         a resume on the card bit for bit equal to the
                 uninterrupted run: ``configs/default_8x8.yaml`` read with
                 the port's reader and cut to 2 iterations of 16 games at
                 4 simulations, its 10 SGD steps at batch 256, a ring of
                 1200 positions (it wraps in iteration 2) and a checkpoint
                 every iteration. Run A trains iterations 1-2; run B, a
                 fresh ``AlphaZeroTrainer``, loads A's checkpoint of
                 iteration 1 and trains to 2. Twice: through the plain bf16
                 forward (the learning run's path; no trunk may launch)
                 and through ``int8_dx3`` (20 launches a forward, no other
                 trunk). A and B equal in every parameter, BatchNorm
                 statistic and momentum buffer, the step, both
                 generators, the ring's slots and counters
                 (``tests/torch_resume.py::resume_leaves``) and iteration
                 2's metrics rows but the wall times; each run's seconds;
9. bench         the port's ``bench.py --mode all --repeats 1`` in process,
                 its JSON line printed (random self-play through
                 ``random_step``, one launch a ply; self-play through
                 ``int8_dx3``; one training iteration), then ``--mode mcts
                 --net-variant int8``: ``trunk_int8`` launched 20 times a
                 network forward;
    benchmark_model  the port's ``benchmark_model --fused`` in process over
                 all ten variants (default batches 1-4096, chain 16,
                 2 repeats): each table printed, every row at B >= 256 a
                 number, each kernel launched 20 times a fused forward
                 (``trunk_int8_dxcat`` once);
    shapes       the trunks at the board sides and widths of the shipped
                 configs besides 10x128 at 8x8, weights from a numpy seed
                 (the trainer's initial ones for the bf16 trunks), on stem
                 outputs of real positions: all eight at 6x6 with 64
                 channels (``configs/debug_6x6.yaml``'s 5x64 network;
                 ``trunk_int8`` with both ``stage_bf16`` settings),
                 ``matmul9``, ``int8_dx3`` and ``int8_dxcat`` also at 8x8
                 with 32 (``parity_4x32.yaml``'s 4x32) and 4x4 with 16
                 (2x16), at B=64, 24 and 1; all eight also at 8x8 with
                 256 channels (weights streamed through shared memory) and
                 6x6 with 40 (run at 48 with zero channels), 2 blocks each,
                 at B=1024, 64 and 1; each to its 8x8 bar: the int8
                 trunks bit for bit and their forward equal to the plain
                 trunk's; the bf16 ones equal to their convs launched one
                 by one, each conv within the bf16 default plus
                 ``sum_error_bound`` (``wide``: plus a bf16 ulp a tap), the
                 forward within probs 0.03 / value 0.05; launches L a
                 forward (``int8_dxcat``: 1). Then ``cli train`` on
                 ``configs/debug_6x6.yaml`` read with the port's YAML reader
                 and cut (``int8_dx3``, 5x64, one iteration of 64 games in
                 one batch at its 10 simulations, 2 SGD steps, a checkpoint),
                 the checkpoint reloaded and its network through the kernel
                 equal to the plain trunk: ``trunk_int8_dx3`` launched 10 x
                 forwards, no other trunk; the same gated through
                 ``int8_dxcat`` with an 8-game gate match (1 launch a
                 forward); self-play and SGD seconds of each, the gate
                 match's. Then the port's ``bench --mode mcts --size 6
                 --filters 64 --blocks 5 --net-variant int8_dx3 --batch 256
                 --repeats 1``, its JSON line (launches 10 x forwards); and
                 each variant's ms a forward at B=1024, 6x6, 64 channels
                 (wall by CUDA events, device by torch.profiler), beside
                 its bounds (the work of 36 positions a game). Then the
                 JAX bench's wide network, ``bench --mode mcts --filters
                 256 --blocks 10 --net-variant int8_dx3 --batch 256
                 --repeats 1 --simulations 8`` (launches 20 x forwards),
                 its seconds beside the 25-simulation run's, and each
                 variant's ms a forward at 8x8 x 256, B=1024, 20 convs,
                 beside its operations bound, the int8 f32 bytes floor and
                 the bf16 ones' cuDNN tower; ``int8_dxcat`` also at B=64
                 and 40 (its device time from CUDA events: the profiler
                 does not trace its cooperative launch);
    profilers    the port's four profilers (``..._torch/profilers/``)
                 through their ``main(argv)``: ``profile_mcts`` (B=1024, 25
                 simulations, ``int8_dx3``: full search, tree+env through a
                 constant network, forward only), ``profile_mcts_parts``
                 (the mid-search tree at 12 of 25 simulations: select walk,
                 parent gather + step + observe, forward, ``masked_probs``,
                 expand + backup, and one whole simulation),
                 ``profile_forward_parts`` at B=1024 and 64 (stem,
                 ``quantize_trunk``, ``int8_dx3`` and ``int8_dxcat`` trunks
                 at 16, 32 and 64 games a scale block, heads, the full
                 ``int8_dx3``, ``int8_dxcat`` and plain bf16 forwards) and
                 ``profile_move_glue`` (B=1024: root noise, the two
                 ``action_probs``, the draw, the trajectory writes, step +
                 blend, the liveness sync; the lockstep game lengths); each
                 JSON line printed. Checks: the device is CUDA; every row
                 present, every figure finite; device-busy ms within the
                 profiled wall ms; trunk launches 20 (``int8_dxcat``: 1) x
                 each row's forwards; the five parts' device operations
                 summing exactly to one whole simulation's;
10. profile      one ply's search at B=1024 through the profilers'
                 harness: wall time, device-busy time and idle share,
                 launches a simulation, time by kernel; checks a complete
                 profiled pass;
11. timing       the eight trunk kernels and their plain versions at B=1024
                 and, for ``matmul9`` and ``wide``, the same folded tower as
                 20 cuDNN convolutions; for those two, ``int8_dx3``,
                 ``trunk_int8``, ``int8_m9``, ``int8_patch`` and
                 ``int8_flat`` the kernel's device time per forward from
                 torch.profiler (summed and first-to-last span), and for
                 the int8 ones also the bytes floor of their f32-activation
                 structure;
                 ``int8_dxcat`` also at its gated path's batches, 64 and 40,
                 wall and device time at 64, 40 and 1024, and ``int8_dx3``
                 at B=64; ``random_step`` and its plain version for one
                 ply of 4,194,304 games (CUDA events; their outputs must be
                 bit-equal); the bounds, launches per forward.

Then one ``{"kernels": [...]}`` JSON line (each kernel with the shapes it
was checked at: [board side, channels], ``random_step`` its board sides;
each trunk's ms a forward at 8x8 x 256 beside that shape's bound, and
its largest difference to its plain version on the trained networks),
the ``nvidia-smi`` line, and the
result line ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero; without CUDA it exits non-zero before any phase.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from othello_reinforcement_learning_test_tpu_torch import (
    bench,
    benchmark,
    benchmark_model,
    cli,
    trained,
)
from othello_reinforcement_learning_test_tpu_torch.apps.web.game_manager import GameManager
from othello_reinforcement_learning_test_tpu_torch.apps.web.server import make_server
from othello_reinforcement_learning_test_tpu_torch.kernels import build
from othello_reinforcement_learning_test_tpu_torch.kernels import random_step as rs
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8 import (
    trunk_int8,
    trunk_int8_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dx3 import (
    block_size,
    trunk_int8_dx3,
    trunk_int8_dx3_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dxcat import (
    LAUNCHES_PER_FORWARD as DXCAT_LAUNCHES_PER_FORWARD,
    trunk_int8_dxcat,
    trunk_int8_dxcat_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_flat import (
    trunk_int8_flat,
    trunk_int8_flat_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_m9 import (
    trunk_int8_m9,
    trunk_int8_m9_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_patch import (
    trunk_int8_patch,
    trunk_int8_patch_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_matmul9 import (
    conv_matmul9,
    conv_plain,
    sum_error_bound,
    trunk_matmul9,
    trunk_matmul9_plain,
)
from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_wide import (
    conv_bound,
    conv_wide,
    conv_wide_plain,
    hwio,
    trunk_wide,
    trunk_wide_plain,
)
from othello_reinforcement_learning_test_tpu_torch.evaluation import (
    Arena,
    GreedyPlayer,
    MCTSPlayer,
    NativeMinimaxPlayer,
)
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
    init_train_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.export import load_exported
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import (
    PORTED_VARIANTS,
    FusedInference,
)
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet
from othello_reinforcement_learning_test_tpu_torch.models.torch_bridge import infer_architecture
from othello_reinforcement_learning_test_tpu_torch.ops import fused_step
from othello_reinforcement_learning_test_tpu_torch.ops.bitboard import get_engine
from othello_reinforcement_learning_test_tpu_torch.profilers import (
    profile_forward_parts,
    profile_mcts,
    profile_mcts_parts,
    profile_move_glue,
)
from othello_reinforcement_learning_test_tpu_torch.profilers.common import Harness
from othello_reinforcement_learning_test_tpu_torch.search import mcts
from othello_reinforcement_learning_test_tpu_torch.train import trainer as trainer_lib
from othello_reinforcement_learning_test_tpu_torch.train.self_play import play_games
from othello_reinforcement_learning_test_tpu_torch.utils.config import load_config, to_yaml

NUM_BLOCKS, NUM_FILTERS = 10, 128
GAMES, SIMS = 1024, 25
SEED = 0
# H100 SXM dense peaks (NVIDIA data sheet): int8 and bf16 tensor cores, HBM3
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
BYTES_PER_S = 3.35e12
# INT32 rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (Hopper white paper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit integer operations a game and ply that random_step.cu cannot do
# without: three floods (both sides' legal squares, the move's flips), each
# 8 directions x 7 shift-and-merge steps x 4 (a 64-bit shift is two 32-bit
# instructions, the and-or merge one 3-input logic instruction per half)
RANDOM_STEP_OPS = 3 * 8 * 7 * 4
# bytes a game and ply: two 64-bit board words read and written, two u32
# random words read, one int32 live written
RANDOM_STEP_BYTES = 2 * 8 + 2 * 8 + 2 * 4 + 4
RANDOM_GAMES = 4194304  # bench.py's random-mode batch with the kernel
# the int8_dx3 and trunk_int8 checks' batches: 1040 gives bg 16 with more
# games than two a CTA, 267 an odd count, 256 the cli phase's self-play
INT8_BATCHES = (GAMES, 1040, 267, 256, 24, 3, 1)
BF16_BATCHES = (GAMES, 267, 24, 3, 1)  # the matmul9 and wide checks' batches
# the profiler names of the int8 conv body's launches and the pre-pass,
# and of the one-launch trunk (int8_dxcat)
INT8_DEVICE_NAMES = ("int8_conv_kernel", "int8_conv_stream_kernel", "prepass_kernel")
TRUNK_DEVICE_NAMES = ("int8_trunk_kernel", "int8_trunk_stream_kernel")
BF16_DEVICE_NAMES = ("bf16_conv_kernel", "bf16_conv_stream_kernel")
# the gated iteration's batches: self-play (64 games), the gate match (40)
GATE_BATCHES = (64, 40)
DXCAT_REPEATS = 200
TRUNK_SOURCE = "othello_reinforcement_learning_test_tpu_torch/csrc/trunk_int8_dx3.cu"
TRUNK_REPLACES = "othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:318"
PALLAS = "othello_reinforcement_learning_test_tpu/models/pallas_resnet.py"
CSRC = "othello_reinforcement_learning_test_tpu_torch/csrc"
# the int8 trunks that compute int8_dx3's function through other data
# movements: kernel, plain version, Pallas kernel's line
INT8_VARIANTS = {"int8_m9": (trunk_int8_m9, trunk_int8_m9_plain, 192),
                 "int8_patch": (trunk_int8_patch, trunk_int8_patch_plain, 230),
                 "int8_flat": (trunk_int8_flat, trunk_int8_flat_plain, 264),
                 "int8_dxcat": (trunk_int8_dxcat, trunk_int8_dxcat_plain, 377)}
# the batches each is checked at
VARIANT_BATCHES = {"int8_m9": INT8_BATCHES, "int8_patch": INT8_BATCHES,
                   "int8_flat": INT8_BATCHES, "int8_dxcat": GATE_BATCHES + INT8_BATCHES}
# the variants that are the int8 conv body at bg 32, each its own library
BODY_BG32 = ("int8_m9", "int8_patch", "int8_flat")
# benchmark_model.py --fused over every variant the port has
BENCH_VARIANTS = ("matmul9", "wide", "int8", "int8_bf16", "int8_m9", "int8_patch", "int8_flat",
                  "int8_dx3", "int8_dxcat", "int8_xla")
VARIANT_KERNEL = {"matmul9": trunk_matmul9, "wide": trunk_wide, "int8": trunk_int8,
                  "int8_bf16": trunk_int8, "int8_m9": trunk_int8_m9,
                  "int8_patch": trunk_int8_patch, "int8_flat": trunk_int8_flat,
                  "int8_dx3": trunk_int8_dx3, "int8_dxcat": trunk_int8_dxcat}
M9_SOURCE = "othello_reinforcement_learning_test_tpu_torch/csrc/trunk_matmul9.cu"
M9_REPLACES = "othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:61"
INT8_SOURCE = "othello_reinforcement_learning_test_tpu_torch/csrc/trunk_int8.cu"
INT8_REPLACES = "othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:149"
STEP_SOURCE = "othello_reinforcement_learning_test_tpu_torch/csrc/random_step.cu"
STEP_REPLACES = "othello_reinforcement_learning_test_tpu/ops/pallas_step.py:162"
SEARCH_GAMES, SEARCH_SIMS = 128, 8
REPO = Path(__file__).resolve().parent


def config_with(name: str, overrides: dict) -> dict:
    """``configs/<name>`` read by the port's ``load_config``, with
    ``overrides`` ({section: {key: value}}, nested blocks merged) on top."""
    cfg = load_config(str(REPO / "configs" / name))
    for section, values in overrides.items():
        for key, value in values.items():
            if isinstance(value, dict):
                cfg[section][key].update(value)
            else:
                cfg[section][key] = value
    return cfg


# configs/run_flagship_r5.yaml, with self-play through matmul9 and a
# checkpoint after the one iteration this script runs
FLAGSHIP = config_with("run_flagship_r5.yaml", {
    "training": {"checkpoint_interval": 1},
    "system": {"self_play_net_variant": "matmul9"}})
SCRATCH = build.BUILD_DIR / "chip_smoke_train"  # git-ignored
ARENA_GAMES = 64
# configs/strong_8x8.yaml, with self-play and gating through int8_dxcat, cut
# so that one iteration gates and checkpoints in about a minute: 64 games in
# one batch (200 in batches of 16), 25 simulations (100), 4 SGD steps (15),
# gating and a checkpoint every iteration (every 25)
STRONG = config_with("strong_8x8.yaml", {
    "training": {"self_play_episodes_per_iter": 64, "train_epochs_per_iter": 4,
                 "checkpoint_interval": 1, "gating": {"interval": 1}},
    "mcts": {"num_simulations": 25},
    "self_play": {"num_parallel_games": 64},
    "system": {"self_play_net_variant": "int8_dxcat"}})
# the cli phase: configs/run_flagship_r5.yaml (10x128, int8_dx3, its lr and
# c_puct) cut to 256 games of 16 simulations, 4 SGD steps at batch 1024, 2
# iterations with a checkpoint each, then resumed to 3; no self-healing, so
# that a kernel fault fails the phase
CLI_SCRATCH = build.BUILD_DIR / "chip_smoke_cli"  # git-ignored
CLI_CUT = {"training": {"self_play_episodes_per_iter": 256, "train_epochs_per_iter": 4,
                        "batch_size": 1024, "num_iterations": 2, "checkpoint_interval": 1},
           "mcts": {"num_simulations": 16},
           "paths": {"checkpoint_dir": str(CLI_SCRATCH / "models"),
                     "log_dir": str(CLI_SCRATCH / "logs"), "data_dir": str(CLI_SCRATCH)},
           "system": {"max_recovery_retries": 0}}
CLI_EXPORT_BATCH = 256
# the distributed phase: two ranks on the one card over gloo, each a process
# running cli train on configs/run_flagship_r5.yaml (10x128, int8_dx3) cut
# to 128 games a rank of 8 simulations, 4 SGD steps at batch 1024 (512 a
# rank), 2 iterations with a checkpoint; then a gated strong_8x8 iteration
# (STRONG: 32 games a rank, a 40-game gate match, 20 a rank) through
# int8_dxcat; then one 2-rank f32 SGD step at 10x128 on 1024 positions
DIST_SCRATCH = build.BUILD_DIR / "chip_smoke_distributed"  # git-ignored
DIST_RANKS = 2
DIST_CUT = {"training": {"self_play_episodes_per_iter": 128 * DIST_RANKS,
                         "train_epochs_per_iter": 4, "batch_size": 1024, "num_iterations": 2,
                         "checkpoint_interval": 2},
            "mcts": {"num_simulations": 8},
            "paths": {"checkpoint_dir": str(DIST_SCRATCH / "models"),
                      "log_dir": str(DIST_SCRATCH / "logs"), "data_dir": str(DIST_SCRATCH)},
            "system": {"max_recovery_retries": 0, "mesh_devices": DIST_RANKS}}
DIST_STEP_BATCH = 1024
DIST_TIMEOUT_S = 600
# the frontends phase: the stub session card vs CPU at 16 simulations; the
# web app's game at the session's default 100 simulations and one move at
# its 500 ceiling (the first AI ply from ply 21); a hint (at half the
# simulations) every 10 plies; one undo at ply 12
FRONT_SCRATCH = build.BUILD_DIR / "chip_smoke_frontends"  # git-ignored
FRONT_STUB_SIMS = 16
FRONT_SIMS, FRONT_MAX_SIMS = 100, 500
FRONT_HINT_EVERY, FRONT_UNDO_AT, FRONT_MAX_AT = 10, 12, 21
STATIC_FILES = ("/", "/css/style.css", "/js/api.js", "/js/board.js", "/js/ui.js", "/js/main.js")
# phase shapes: the trunks at the board sides and widths the shipped configs
# use besides 10x128 at 8x8, each network's depth its config's: (S, C) ->
# (blocks, the trunks checked there, the batches). configs/debug_6x6.yaml's
# 5x64 at 6x6 takes all eight (int8 with both stage_bf16 settings);
# parity_4x32.yaml's 4x32 at 8x8 and a 2x16 network at 4x4 (test.yaml's
# width) the three bodies' trunks; all eight also past 128 channels, where
# the weights are streamed (8x8 x 256, the JAX bench's --filters 256), and
# at a width that is no multiple of 16 (6x6 x 40, run at 48 with zero
# channels), both cut to 2 blocks, at B = 1024, 64, 1
SHAPE_VARIANTS = ("matmul9", "wide", "int8", "int8_bf16", "int8_m9", "int8_patch",
                  "int8_flat", "int8_dx3", "int8_dxcat")
SHAPE_BATCHES = (64, 24, 1)
WIDE_BATCHES = (1024, 64, 1)
SHAPE_NETS = {(6, 64): (5, SHAPE_VARIANTS, SHAPE_BATCHES),
              (8, 32): (4, ("matmul9", "int8_dx3", "int8_dxcat"), SHAPE_BATCHES),
              (4, 16): (2, ("matmul9", "int8_dx3", "int8_dxcat"), SHAPE_BATCHES),
              (8, 256): (2, SHAPE_VARIANTS, WIDE_BATCHES),
              (6, 40): (2, SHAPE_VARIANTS, WIDE_BATCHES)}
# each kernel's library at every shape phase shapes runs, built in the build
# phase beside the 8x8/128 ones (6x6 x 40 at its library's 48)
SHAPE_BUILDS = sorted({(VARIANT_KERNEL[v].__name__, (shape[0], build.padded_channels(shape[1])))
                       for shape, (_, variants, _) in SHAPE_NETS.items() for v in variants})
SHAPES_SCRATCH = build.BUILD_DIR / "chip_smoke_shapes"  # git-ignored
# configs/debug_6x6.yaml (6x6, 5x64) through int8_dx3, cut to one iteration
# of 64 games in one batch at its own 10 simulations, 2 SGD steps at its
# batch of 128, a checkpoint; then gated through int8_dxcat with an 8-game
# gate match (at its 25 evaluation simulations)
DEBUG_6X6_CUT = {"training": {"self_play_episodes_per_iter": 64, "num_iterations": 1,
                              "train_epochs_per_iter": 2, "checkpoint_interval": 1},
                 "self_play": {"num_parallel_games": 64},
                 "paths": {"checkpoint_dir": str(SHAPES_SCRATCH / "models"),
                           "log_dir": str(SHAPES_SCRATCH / "logs"),
                           "data_dir": str(SHAPES_SCRATCH)},
                 "system": {"self_play_net_variant": "int8_dx3", "max_recovery_retries": 0}}
DEBUG_6X6_GATE = {"enabled": True, "games": 8, "interval": 1, "win_threshold": 0.55,
                  "num_simulations": None, "opening_random_plies": 4}  # None: the eval count
SHAPES_BENCH = ["--mode", "mcts", "--size", "6", "--filters", "64", "--blocks", "5",
                "--net-variant", "int8_dx3", "--batch", "256", "--repeats", "1"]
# the JAX bench's wide network through the streamed int8_dx3 trunk, at 8
# simulations: its time is the host's search loop, set by the simulations
# and not by the batch; printed beside the timed run's seconds at the
# bench's 25 (256 games at 12.14 games/s on an H100 80GB HBM3 at 700 W)
WIDE_BENCH = ["--mode", "mcts", "--filters", "256", "--blocks", "10", "--net-variant",
              "int8_dx3", "--batch", "256", "--repeats", "1", "--simulations", "8"]
WIDE_BENCH_WALL_S_AT_25 = 21.087
WIDE_FILTERS = 256  # the timing rows past 128 channels: 8x8, 10 blocks, B = GAMES
# phase trained: the repo's trained networks (..._torch/trained/, converted
# from the JAX package's checkpoints), every trunk kernel held on their
# weights, each variant's forward against the plain bf16 forward at these
# batches (top legal move agreement and value correlation at the JAX
# package's bars for quantized inference, tests/test_int8_strength.py), and
# flagship r5 against Greedy at the protocol of its JAX record (50 games, 4
# random opening plies, colours alternating) but TRAINED_MATCH_SIMS
# simulations in place of its 100, which must win a majority of its games
# (46-4 and 58-2 recorded at 100). The match's time is the host's search
# loop, set by the simulations (printed beside its seconds at 100 on an
# H100 80GB HBM3 at 700 W); the record's full protocol runs in benchmark_ai
TRAINED_BATCHES = (GAMES, 64)
TRAINED_AGREEMENT, TRAINED_VALUE_CORR = 0.9, 0.95
TRAINED_MATCH_RECORD = ("flagship_r5", "results.Greedy")
TRAINED_MATCH_SIMS = 25
TRAINED_MATCH_WINS = 26
TRAINED_MATCH_S_AT_RECORD = 166.057
TRAINED_SCRATCH = build.BUILD_DIR / "chip_smoke_trained"  # git-ignored
# the two ablation recipes that made committed networks, each through the
# port's YAML reader cut to one iteration of 64 games in one batch at 8
# simulations, 2 SGD steps, a checkpoint; self-play through int8_dx3 (the
# symaug recipe's own variant; the prioritized one plays through the plain
# forward, so its cut sets it, to put the kernel on the path)
ABLATIONS = ("run_500iter_prioritized.yaml", "run_500iter_symaug.yaml")
ABLATION_CUT = {"training": {"self_play_episodes_per_iter": 64, "num_iterations": 1,
                             "train_epochs_per_iter": 2, "checkpoint_interval": 1},
                "mcts": {"num_simulations": 8},
                "self_play": {"num_parallel_games": 64},
                "system": {"self_play_net_variant": "int8_dx3", "max_recovery_retries": 0}}
# phase learn: configs/default_8x8.yaml (10x128, self-play through the plain
# bf16 forward) cut to 2 iterations of 16 games at 4 simulations with its 10
# SGD steps at batch 256, a ring of 1200 positions (about 960 plies an
# iteration, so it wraps in iteration 2) and a checkpoint every iteration;
# run through the plain forward and through int8_dx3: (variant, its kernel)
LEARN_SCRATCH = build.BUILD_DIR / "chip_smoke_learn"  # git-ignored
LEARN_CUT = {"training": {"self_play_episodes_per_iter": 16, "num_iterations": 2,
                          "replay_buffer_size": 1200, "checkpoint_interval": 1},
             "mcts": {"num_simulations": 4},
             "system": {"max_recovery_retries": 0}}
LEARN_PATHS = (("xla", None), ("int8_dx3", trunk_int8_dx3))
# phase profilers: the port's four profilers through their main(argv) at
# B=GAMES, SIMS simulations, 10x128 through int8_dx3 (the forward's parts
# also at the gate match's B=64, with int8_dxcat's full forward), few
# repeats; each with the rows it must print
PROFILE_PARTS = ["select walk", "parent gather+step+obs", "forward", "masked_probs",
                 "expand+backup"]
FORWARD_ROWS = (["stem (conv 3->C + BN)", "quantize_trunk (hoisted)"]
                + [f"trunk int8_{k} bg={bg}" for k in ("dx3", "dxcat") for bg in (16, 32, 64)]
                + ["heads (1x1 convs + dense)", "full fused int8_dx3", "full fused int8_dxcat",
                   "full plain bf16"])
FORWARD_ARGS = ["--reps", "10", "--repeats", "2", "--full-variants", "int8_dx3", "int8_dxcat"]
PROFILE_REPEATS = 2  # phase profile's and the web game's timed searches
PROFILER_RUNS = (
    (profile_mcts, ["--batch", str(GAMES), "--sims", str(SIMS), "--chain", "1", "--repeats",
                    "2", "--net-variant", "int8_dx3"],
     ["full search", "tree+env only", "forward only"]),
    (profile_mcts_parts, ["--batch", str(GAMES), "--sims", str(SIMS), "--warm-sims", "12",
                          "--reps", "5", "--repeats", "2", "--net-variant", "int8_dx3"],
     PROFILE_PARTS + ["whole simulation"]),
    (profile_forward_parts, ["--batch", str(GAMES)] + FORWARD_ARGS, FORWARD_ROWS),
    (profile_forward_parts, ["--batch", str(GATE_BATCHES[0])] + FORWARD_ARGS, FORWARD_ROWS),
    (profile_move_glue, ["--batch", str(GAMES), "--reps", "10", "--repeats", "2"],
     ["dirichlet noise (gamma B*A)", "action_probs x2", "categorical sample (Gumbel-max)",
      "trajectory writes x5", "engine.step + blend", "liveness sync"]),
)


def launches_per_forward(kernel, layers: int = 2 * NUM_BLOCKS) -> int:
    """A trunk kernel's launches a forward of ``layers`` convs: one a conv,
    but int8_dxcat's whole trunk in one."""
    return DXCAT_LAUNCHES_PER_FORWARD if kernel is trunk_int8_dxcat else layers


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
    """One self-play ply's search (SIMS simulations) through the
    profilers' harness (``profilers/common.py``: warm-up, host wall with a
    sync, best of PROFILE_REPEATS; profiled passes between marker kernels,
    retried until complete): its wall time, device-busy time, idle share
    against the unprofiled wall, launches a simulation and the device time
    by kernel. Checks a complete profiled pass."""
    with contextlib.redirect_stdout(io.StringIO()):  # the harness's printed row
        row = Harness(boards.me.device, 1, PROFILE_REPEATS, top=None).time(
            "search", lambda: mcts.search(engine, net, boards, SIMS), forwards=SIMS + 1)
    check(row["profile_complete"], f"a profiled pass of the search recorded every marker "
                                   f"({row['passes']})")
    busy, wall = row["device_busy_ms"], row["wall_ms"]["best"]
    trunk = sum(ms for name, ms, _ in row["top"]
                if "conv_kernel" in name or "prepass_kernel" in name)
    return {"wall_ms": wall, "wall_ms_median": row["wall_ms"]["median"],
            "profiled_wall_ms": row["profiled_wall_ms"], "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall, "trunk_kernel_ms": trunk,
            "device_launches_per_sim": row["launches"] / SIMS, "syncs": row["syncs"],
            "tries": row["tries"], "top": row["top"][:6]}


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


def trunk_device_ms(fn, names=("bf16_conv_kernel",), reps: int = 10) -> dict:
    """A trunk's device time per forward under torch.profiler: the durations
    of its launches (kernels whose name holds one of ``names``) summed
    (``device_ms``), the span from the first launch's start to the last
    one's end (``device_span_ms``, which also counts the gaps between
    launches), and the launches a forward."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and any(n in e.name for n in names)]
    if not kernels:  # the one-launch trunk's cooperative launch is not traced
        return event_device_ms(fn, reps)
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    return {"device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps,
            "device_span_ms": (end - start) / 1e3 / reps,
            "device_launches_per_forward": len(kernels) / reps}


def event_device_ms(fn, reps: int = 10) -> dict:
    """A forward's device time from CUDA events recorded on the stream just
    before and after each call, the stream held busy ahead of them
    (``torch.cuda._sleep``) so that the host's enqueue is not timed: what
    the stream runs between the two events (for ``int8_dxcat`` its memset
    and its one launch)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)  # about 1 ms of spinning at the boost clock
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return {"device_ms": total / reps, "device_by": "cuda events"}


def wgmma_evidence(builds: dict) -> None:
    """The wgmma trunks' wgmma instruction count from ``cuobjdump -sass``,
    where the toolkit has it (their ptxas report is in the build lines):
    HGMMA (bf16) in ``trunk_matmul9`` and ``trunk_wide``, IGMMA (s8) in
    ``trunk_int8_dx3``, ``trunk_int8``, ``trunk_int8_m9``,
    ``trunk_int8_patch``, ``trunk_int8_flat`` and ``trunk_int8_dxcat``."""
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    for kname, op in (("trunk_matmul9", "HGMMA"), ("trunk_wide", "HGMMA"),
                      ("trunk_int8_dx3", "IGMMA"), ("trunk_int8", "IGMMA"),
                      ("trunk_int8_m9", "IGMMA"), ("trunk_int8_patch", "IGMMA"),
                      ("trunk_int8_flat", "IGMMA"), ("trunk_int8_dxcat", "IGMMA")):
        count = "not measured"
        if cuobjdump.is_file():
            sass = subprocess.run([str(cuobjdump), "-sass", str(builds[kname].path)],
                                  capture_output=True, text=True, timeout=120).stdout
            count = sum(op in ln for ln in sass.splitlines())
            check(count > 0, f"{kname} issues wgmma ({op} in its SASS)")
        phase("build", kernel=kname, **{f"{op.lower()}_instructions": count})


def trunk_bound_ms(batch: int, layers: int, channels: int, bf16: bool = False,
                   size: int = 8) -> tuple:
    """Least time for one trunk forward on this card: operations over the
    tensor-core rate of their type, bytes (bf16 in and out; int8 weights
    with f32 scales and biases, or bf16 weights with f32 biases; each moved
    once) over the memory rate. The work of the batch's size x size boards
    (at 6x6 the kernels compute 64 rows a game and keep 36)."""
    rows = batch * size * size
    ops = layers * rows * channels * channels * 9 * 2
    if bf16:
        w_bytes, rate = layers * (9 * channels * channels * 2 + channels * 4), BF16_OPS_PER_S
    else:
        w_bytes, rate = layers * (9 * channels * channels + 2 * channels * 4), INT8_OPS_PER_S
    nbytes = 2 * rows * channels * 2 + w_bytes
    t_ops, t_bytes = ops / rate * 1e3, nbytes / BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def int8_bytes_floor_ms(batch: int, layers: int, channels: int, size: int = 8) -> float:
    """Least time for one forward of the int8 trunks as they are built: the
    per-block activation scale spans games that no CTA holds whole, so each
    conv is its own launch and the activations cross device memory in f32.
    Bytes: the pre-pass reads the bf16 input and writes it in f32; each
    block's conv 0 reads x and writes y, its conv 1 reads y and x and writes
    x (bf16 on the last layer); the int8 weights with f32 scales and biases;
    each moved once, over the memory rate."""
    act = batch * size * size * channels * 4  # one f32 activation tensor
    nbytes = (act // 2 + act) + layers // 2 * 5 * act - act // 2 \
        + layers * (9 * channels * channels + 2 * channels * 4)
    return nbytes / BYTES_PER_S * 1e3


def batch_of(feats: torch.Tensor, batch: int) -> torch.Tensor:
    """The first ``batch`` rows of ``feats``, its first rows repeated past its
    end (B=1040 from 1,024 positions)."""
    return torch.cat([feats, feats])[:batch]


def matmul9_bound(src, w, b, want):
    """PyTorch's bf16 default plus the f32 summation bound of one conv."""
    return 1e-5 + 1.6e-2 * want.float().abs() + sum_error_bound(src, w, b)


def check_bf16_convs(name, trunk, trunk_plain, conv, conv_ref, bound, fused, feats,
                     weights: str, batches=BF16_BATCHES) -> float:
    """A bf16 trunk kernel against its plain version (see the module
    docstring): the whole trunk equal bit for bit to its 20 convs launched
    one by one, and each conv within ``bound(src, w, b, want)`` of the plain
    conv on the plain chain's own input. Returns the largest per-conv
    difference."""
    w, b = fused.trunk_w, fused.trunk_bias
    max_abs_err = 0.0
    for batch in batches:
        h = fused.stem(feats[:batch])
        out_k = trunk(h, w, b)
        # the same 20 convs launched one by one: the kernel sums in a fixed
        # order, so the trunk's loop (layer, residual, in-place conv 1) must
        # give this chain bit for bit
        chain = h
        for i in range(0, w.shape[0], 2):
            y = conv(chain, w[i], b[i])
            chain = conv(y, w[i + 1], b[i + 1], resid=chain)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k.float()).all()), f"finite {name} output")
        check(torch.equal(out_k, chain), f"{name} == its 20 convs chained at B={batch}")
        out_p = trunk_plain(h, w, b)
        trunk_diff = (out_k.float() - out_p.float()).abs()
        n_diff, n_default, n_bad, conv_err = 0, 0, 0, 0.0
        for i in range(w.shape[0]):  # every conv, on the plain chain's own inputs
            resid = h if i % 2 else None
            src = y if i % 2 else h
            got = conv(src, w[i], b[i], resid).float()
            want = conv_ref(src, w[i], b[i], resid)
            diff = (got - want.float()).abs()
            n_diff += int((diff != 0).sum())
            n_default += int((diff > 1e-5 + 1.6e-2 * want.float().abs()).sum())
            n_bad += int((diff > bound(src, w[i], b[i], want)).sum())
            conv_err = max(conv_err, float(diff.max()))
            if i % 2:
                h = want
            else:
                y = want
        max_abs_err = max(max_abs_err, conv_err)
        phase("kernel_check", kernel=name, weights=weights, batch=batch,
              convs_differing=n_diff, convs_outside_bf16_default=n_default,
              convs_outside_tolerance=n_bad, of=out_k.numel() * w.shape[0],
              conv_max_abs_diff=conv_err, trunk_differing=int((trunk_diff != 0).sum()),
              trunk_of=out_k.numel(), trunk_max_abs_diff=float(trunk_diff.max()),
              trunk_equals_chained_convs=True)
        check(n_bad == 0, f"every {name} conv within tolerance of the plain conv at "
              f"B={batch} ({n_bad} elements outside)")
    return max_abs_err


def plain_witnesses(fused, plain, h, plain_out, w_reversed) -> dict:
    """Second witnesses of a bf16 trunk's plain version: the same function
    summing in other correct f32 orders, to show how far two orders drift
    apart through the 20 convs. On the CPU; and on the card with the nine
    taps and the input channels of every product summed in reverse order
    (board and kernel flipped, channels reversed: the same function;
    ``w_reversed`` is the weights so reversed). Returns {witness:
    differences to ``plain_out``, the trunk's and the forward's}."""
    w, b = fused.trunk_w, fused.trunk_bias
    r = torch.arange(h.shape[-1] - 1, -1, -1, device=h.device)
    witnesses = {
        "plain_cpu": plain(h.cpu(), w.cpu(), b.cpu()).to(h.device),
        "plain_reversed": plain(h.flip(1, 2)[..., r], w_reversed, b[:, r])[..., r].flip(1, 2),
    }
    lp_p, v_p = fused.heads(plain_out)
    fields = {}
    for wname, other in witnesses.items():
        lp_o, v_o = fused.heads(other)
        diff = (plain_out.float() - other.float()).abs()
        fields[wname] = {"trunk_differing": int((diff != 0).sum()),
                         "trunk_max_abs_diff": float(diff.max()),
                         "probs": float((lp_p.exp() - lp_o.exp()).abs().max()),
                         "value": float((v_p - v_o).abs().max())}
    return fields


def forward_bars(witnesses: dict, from_witnesses: bool) -> tuple:
    """The bf16 forward's bars (probs, value): 0.03 / 0.05, or where
    ``from_witnesses`` (trained weights, whose sharp policies move further
    under a change of summation order) at least twice the largest drift
    between the plain version and its witnesses."""
    if not from_witnesses:
        return 0.03, 0.05
    return (max(0.03, 2 * max(f["probs"] for f in witnesses.values())),
            max(0.05, 2 * max(f["value"] for f in witnesses.values())))


def check_matmul9(fused_m9, feats, weights: str, check_forward: bool,
                  witness_bars: bool = False, batches=BF16_BATCHES) -> float:
    """The matmul9 kernel against its plain version at ``batches`` (see the
    module docstring); returns the largest per-conv difference.
    ``witness_bars``: the forward's bars from :func:`forward_bars`."""
    w, b = fused_m9.trunk_w, fused_m9.trunk_bias
    max_abs_err = check_bf16_convs("trunk_matmul9", trunk_matmul9, trunk_matmul9_plain,
                                   conv_matmul9, conv_plain, matmul9_bound, fused_m9, feats,
                                   weights, batches)
    h = fused_m9.stem(feats)
    plain = trunk_matmul9_plain(h, w, b)
    lp_k, v_k = fused_m9(feats)
    lp_p, v_p = fused_m9.heads(plain)
    dp = float((lp_k.exp() - lp_p.exp()).abs().max())
    dv = float((v_k - v_p).abs().max())
    r = torch.arange(w.shape[-1] - 1, -1, -1, device=h.device)
    fields = plain_witnesses(fused_m9, trunk_matmul9_plain, h, plain,
                             w.flip(1, 2)[..., r, :][..., r])
    bar_p, bar_v = forward_bars(fields, witness_bars)
    phase("kernel_check", what="FusedInference(matmul9) kernel vs plain trunk", weights=weights,
          batch=feats.shape[0], max_abs_diff_probs=dp, max_abs_diff_value=dv,
          checked=check_forward, bar_probs=bar_p, bar_value=bar_v, plain_vs=fields)
    if check_forward:
        check(dp <= bar_p and dv <= bar_v,
              f"FusedInference(matmul9) within probs {bar_p}, value {bar_v}")
    return max_abs_err


def check_wide(fused_w, feats, weights: str, check_forward: bool,
               witness_bars: bool = False, batches=BF16_BATCHES) -> float:
    """The wide kernel against its plain version at ``batches``, conv by
    conv within ``conv_bound`` (PyTorch's bf16 default, the f32 summation
    bound and one bf16 ulp of each tap's product), the trunk equal to its 20
    convs; FusedInference(wide) against the plain trunk at probs 0.03 /
    value 0.05 where ``check_forward`` (``witness_bars``: the bars of
    :func:`forward_bars`, the witnesses printed). Returns the largest
    per-conv difference."""
    err = check_bf16_convs("trunk_wide", trunk_wide, trunk_wide_plain, conv_wide,
                           conv_wide_plain, conv_bound, fused_w, feats, weights, batches)
    w, b = fused_w.trunk_w, fused_w.trunk_bias
    h = fused_w.stem(feats)
    plain = trunk_wide_plain(h, w, b)
    lp_k, v_k = fused_w(feats)
    lp_p, v_p = fused_w.heads(plain)
    dp = float((lp_k.exp() - lp_p.exp()).abs().max())
    dv = float((v_k - v_p).abs().max())
    fields = {}
    if witness_bars:  # (L, C_in, 9 taps, C_out): taps and both channel axes reversed
        L, C = w.shape[:2]
        r = torch.arange(C - 1, -1, -1, device=h.device)
        fields = plain_witnesses(fused_w, trunk_wide_plain, h, plain,
                                 w.reshape(L, C, 9, C)[:, r][..., r].flip(2).reshape(L, C, 9 * C))
    bar_p, bar_v = forward_bars(fields, witness_bars)
    phase("kernel_check", what="FusedInference(wide) kernel vs plain trunk", weights=weights,
          batch=feats.shape[0], max_abs_diff_probs=dp, max_abs_diff_value=dv,
          checked=check_forward, bar_probs=bar_p, bar_value=bar_v, plain_vs=fields)
    if check_forward:
        check(dp <= bar_p and dv <= bar_v,
              f"FusedInference(wide) within probs {bar_p}, value {bar_v}")
    return err


def check_int8_variants(model, feats, weights: str = "he_normal", batches=None) -> dict:
    """The int8_m9, int8_patch, int8_flat and int8_dxcat kernels against
    their plain versions at their VARIANT_BATCHES (or ``batches``), bit for
    bit, each call launching launches_per_forward; int8_dxcat also in DXCAT_REPEATS
    forwards at each of GATE_BATCHES; FusedInference with each kernel
    against the plain trunk. Returns {variant: (largest difference,
    FusedInference)}."""
    out = {}
    for variant, (kernel, plain, _) in INT8_VARIANTS.items():
        fused = FusedInference(model, variant=variant)
        args = (fused.trunk_w, fused.trunk_scale, fused.trunk_bias, fused.block_games)
        err = 0.0
        for batch in batches or VARIANT_BATCHES[variant]:
            h = fused.stem(batch_of(feats, batch))
            before = kernel.launches
            out_k = kernel(h, *args)
            launched = kernel.launches - before
            out_p = plain(h, *args)
            torch.cuda.synchronize()
            diff = (out_k.float() - out_p.float()).abs()
            n_diff = int((diff != 0).sum())
            err = max(err, float(diff.max()))
            check(bool(torch.isfinite(out_k.float()).all()), f"finite {variant} output")
            phase("kernel_check", kernel=kernel.__name__, weights=weights, batch=batch,
                  block_games=block_size(batch, fused.block_games), differing=n_diff,
                  of=out_k.numel(), max_abs_diff=float(diff.max()), launches=launched)
            check(n_diff == 0, f"{kernel.__name__} == plain version at B={batch}")
            check(launched == launches_per_forward(kernel),
                  f"{kernel.__name__} launched {launched} times a forward")
        if kernel is trunk_int8_dxcat:
            for batch in GATE_BATCHES:
                h = fused.stem(feats[:batch])
                want = plain(h, *args)
                bad = sum(not torch.equal(kernel(h, *args), want) for _ in range(DXCAT_REPEATS))
                phase("kernel_check", kernel=kernel.__name__, weights=weights, batch=batch,
                      repeats=DXCAT_REPEATS, forwards_differing=bad)
                check(bad == 0, f"{kernel.__name__} == plain version in {DXCAT_REPEATS} "
                      f"forwards at B={batch} ({bad} differ)")
        lp_k, v_k = fused(feats)
        lp_p, v_p = fused.heads(plain(fused.stem(feats), *args))
        check(torch.equal(lp_k, lp_p) and torch.equal(v_k, v_p),
              f"FusedInference({variant}) kernel == plain trunk")
        out[variant] = (err, fused)
    # the bg-32 instances of the conv body, each library with its own weight
    # maps keyed on the address, taking turns on one weight tensor whose
    # contents are rewritten in place between rounds
    fp = out["int8_patch"][1]
    w = fp.trunk_w.clone()
    h = fp.stem(feats[:GATE_BATCHES[0]])
    for step in range(2):
        if step:
            w.copy_(w.flip(2))  # other weights, the same address
        for variant in BODY_BG32:
            kernel, plain, _ = INT8_VARIANTS[variant]
            args = (w, fp.trunk_scale, fp.trunk_bias, fp.block_games)
            check(torch.equal(kernel(h, *args), plain(h, *args)),
                  f"{kernel.__name__} == plain on weights rewritten at one address ({step})")
    phase("kernel_check", what="int8 conv body libraries on one weight address rewritten",
          weights=weights, kernels=[INT8_VARIANTS[v][0].__name__ for v in BODY_BG32],
          rounds=2, equal=True)
    return out


def train_step_check(engine, feats: torch.Tensor, rng: np.random.Generator) -> None:
    """One f32 SGD step from the trainer's initial weights on one fixed
    batch, on the card and on the CPU (see the module docstring for the
    bars)."""
    legal = engine.legal_actions(engine.initial_state((1,), device="cpu"))  # shape only
    pi = rng.random((feats.shape[0], legal.shape[-1])).astype(np.float32)
    pi /= pi.sum(-1, keepdims=True)
    tv = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (feats.shape[0], 1))
    cfg = {"training": {"lr": 0.006, "momentum": 0.9, "weight_decay": 1e-4}}
    start = from_jax_variables(init_train_variables(NUM_BLOCKS, NUM_FILTERS, SEED + 1))
    runs = []
    for dev in ("cuda", "cpu"):
        m = OthelloResNet(NUM_BLOCKS, NUM_FILTERS)
        m.load_state_dict(start)
        m.to(dev)
        state = trainer_lib.TrainState(m, trainer_lib.make_optimizer(m, cfg))
        t0 = time.perf_counter()
        metrics = trainer_lib.train_on_batch(
            state, feats.to(dev), torch.from_numpy(pi).to(dev), torch.from_numpy(tv).to(dev),
            trainer_lib.make_lr_schedule(cfg), torch.float32)
        runs.append((float(metrics["loss"]),
                     {k: t.cpu().double() for k, t in m.state_dict().items()
                      if t.is_floating_point()}, time.perf_counter() - t0))
    (loss_c, sd_c, s_c), (loss_h, sd_h, s_h) = runs
    params = [k for k in sd_h if "running" not in k]
    # worst relative L2 error of a parameter's update, card vs CPU
    card_err = max(float((sd_c[k] - sd_h[k]).norm()
                         / (sd_h[k] - start[k].double()).norm().clamp_min(1e-30)) for k in params)

    def worst(names):  # largest |card - cpu| / (atol 1e-6 + rtol 1e-4 * |cpu|)
        return max(float(((sd_c[k] - sd_h[k]).abs() / (1e-6 + 1e-4 * sd_h[k].abs())).max())
                   for k in names)

    params_worst = worst(params)
    stats_worst = worst([k for k in sd_h if "running" in k])
    phase("train_step_check", batch=feats.shape[0], loss_cuda=loss_c, loss_cpu=loss_h,
          loss_rel_diff=abs(loss_c / loss_h - 1), params_worst_over_tolerance=params_worst,
          stats_worst_over_tolerance=stats_worst, update_rel_err_card_vs_cpu=card_err,
          cuda_s=round(s_c, 3), cpu_s=round(s_h, 3))
    check(abs(loss_c / loss_h - 1) <= 1e-4, "train step loss on the card == CPU (rtol 1e-4)")
    check(params_worst <= 1.0 and stats_worst <= 1.0,
          "updated parameters and BatchNorm statistics on the card == CPU (rtol 1e-4, atol 1e-6)")


def train_iteration(dev) -> int:
    """One flagship-recipe training iteration through the matmul9 kernel,
    and a reload of its checkpoint. Returns the kernel's launches."""
    shutil.rmtree(SCRATCH, ignore_errors=True)
    cfg = json.loads(json.dumps(FLAGSHIP))
    cfg["paths"] = {"checkpoint_dir": str(SCRATCH / "models"), "log_dir": str(SCRATCH / "logs")}
    tr = trainer_lib.AlphaZeroTrainer(cfg, log_cb=None)
    check(tr.device.type == "cuda" and tr.variant == "matmul9", "trainer on the card, matmul9")
    forwards, trajs, step_losses = 0, [], []
    make_net, run_self_play, train_steps = tr.selfplay_net, tr.run_self_play, trainer_lib.train_steps

    def counted_net():
        net = make_net()

        def f(x):
            nonlocal forwards
            forwards += 1
            return net(x)
        return f

    def captured_self_play(n, **kw):
        trajs.append(run_self_play(n, **kw))
        return trajs[-1]

    def captured_steps(*a, **kw):
        step_losses.extend(train_steps(*a, **kw))
        return step_losses

    tr.selfplay_net, tr.run_self_play = counted_net, captured_self_play
    trainer_lib.train_steps = captured_steps
    before = {k: t.clone() for k, t in tr.model.state_dict().items()}
    torch.cuda.synchronize()
    trunk_matmul9.launches = 0
    trunk_int8_dx3.launches = 0
    t0 = time.perf_counter()
    try:
        scalars = tr._train_iteration(0, tr.episodes_per_iter, tr.num_iterations, [], [])
    finally:
        trainer_lib.train_steps = train_steps
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = trunk_matmul9.launches
    valid = int(trajs[0].mask.sum())
    losses = [float(m["loss"]) for m in step_losses]
    moved = sum(not torch.equal(before[k], t) for k, t in tr.model.state_dict().items())
    check(launches > 0 and launches == 2 * NUM_BLOCKS * forwards,
          f"matmul9 launches {launches} == 20 x forwards {forwards}")
    check(trunk_int8_dx3.launches == 0, "no int8 trunk in the matmul9 iteration")
    check(tr.buffer.filled == valid, f"buffer fill {tr.buffer.filled} == valid plies {valid}")
    check(len(losses) == 24 and all(np.isfinite(losses)), "24 finite losses")
    check(moved > 0, "parameters moved")
    path = SCRATCH / "models" / "checkpoint_iter_000001.pt"
    check(path.is_file(), "checkpoint written")
    t1 = time.perf_counter()
    fresh = trainer_lib.AlphaZeroTrainer(cfg, log_cb=None)
    fresh.load_checkpoint(str(path))
    reload_s = time.perf_counter() - t1
    same = (all(torch.equal(t, fresh.model.state_dict()[k]) for k, t in tr.model.state_dict().items())
            and all(torch.equal(a["momentum_buffer"], b["momentum_buffer"]) for a, b in zip(
                tr.state.optimizer.state_dict()["state"].values(),
                fresh.state.optimizer.state_dict()["state"].values()))
            and all(torch.equal(getattr(tr.buffer, f), getattr(fresh.buffer, f))
                    for f in ("me", "opp", "pi", "value"))
            and (tr.buffer.cursor, tr.buffer.filled) == (fresh.buffer.cursor, fresh.buffer.filled)
            and torch.equal(tr.rng.get_state(), fresh.rng.get_state())
            and torch.equal(tr.sample_rng.get_state(), fresh.sample_rng.get_state())
            and (tr.state.step, tr.state.iteration) == (fresh.state.step, fresh.state.iteration))
    check(same, "the checkpoint reloads into a fresh trainer with every tensor equal")
    sp_s, sgd_s, ck_s = scalars["Time/self_play"], scalars["Time/train"], tr.last_checkpoint_seconds
    phase("train", games=tr.episodes_per_iter, simulations=tr.num_simulations,
          variant=tr.variant, compute_dtype=str(tr.compute_dtype), forwards=forwards,
          trunk_launches=launches, valid_plies=valid, buffer_filled=tr.buffer.filled,
          sgd_steps=len(losses), loss_first=losses[0], loss_last=losses[-1],
          loss_mean=scalars["Loss/train"], params_moved=moved,
          self_play_s=round(sp_s, 3), games_per_s=round(tr.episodes_per_iter / sp_s, 3),
          sgd_s=round(sgd_s, 3), checkpoint_s=round(ck_s, 3),
          checkpoint_mb=round(path.stat().st_size / 2 ** 20, 1),
          reload_s=round(reload_s, 3), iteration_s=round(seconds, 3))
    tr.close()
    fresh.close()
    shutil.rmtree(SCRATCH, ignore_errors=True)
    return launches


def check_int8_dx3(fused, feats, weights: str = "he_normal", batches=INT8_BATCHES) -> tuple:
    """The int8_dx3 kernel against its plain version at each of
    ``batches``, bit for bit, and FusedInference with it against the plain
    trunk: equal. Returns (largest difference, the forward's (log_probs,
    value))."""
    w, ws, b = fused.trunk_w, fused.trunk_scale, fused.trunk_bias
    max_abs_err = 0.0
    for batch in batches:
        h = fused.stem(batch_of(feats, batch))
        out_k = trunk_int8_dx3(h, w, ws, b)
        out_p = trunk_int8_dx3_plain(h, w, ws, b)
        torch.cuda.synchronize()
        diff = (out_k.float() - out_p.float()).abs()
        n_diff, err = int((diff != 0).sum()), float(diff.max())
        max_abs_err = max(max_abs_err, err)
        check(bool(torch.isfinite(out_k.float()).all()), "finite trunk output")
        bad_games = torch.nonzero(diff.reshape(batch, -1).amax(dim=1) > 0).flatten()
        phase("kernel_check", weights=weights, batch=batch, block_games=block_size(batch),
              differing=n_diff, of=out_k.numel(), max_abs_diff=err,
              games_differing=len(bad_games), first_games=bad_games[:8].tolist())
        check(n_diff == 0, f"trunk kernel == plain version at B={batch} "
              f"({n_diff} elements differ, max {err})")
    lp_k, v_k = fused(feats)
    lp_p, v_p = fused.heads(trunk_int8_dx3_plain(fused.stem(feats), w, ws, b))
    fused_lp = float((lp_k - lp_p).abs().max())
    fused_v = float((v_k - v_p).abs().max())
    phase("kernel_check", what="FusedInference kernel vs plain trunk", weights=weights,
          max_abs_diff_log_probs=fused_lp, max_abs_diff_value=fused_v)
    check(fused_lp == 0.0 and fused_v == 0.0, "FusedInference kernel == plain trunk")
    return max_abs_err, (lp_k, v_k)


def check_trunk_int8(model, feats, weights: str = "he_normal", batches=INT8_BATCHES) -> tuple:
    """The trunk_int8 kernel against its plain version, both stage_bf16
    settings, at each of ``batches``, bit for bit; returns (largest
    difference, FusedInference(int8))."""
    fused8 = FusedInference(model, variant="int8")
    w, ws, b = fused8.trunk_w, fused8.trunk_scale, fused8.trunk_bias
    err = 0.0
    for stage in (False, True):
        for batch in batches:
            h = fused8.stem(batch_of(feats, batch))
            out_k = trunk_int8(h, w, ws, b, stage_bf16=stage)
            out_p = trunk_int8_plain(h, w, ws, b, stage_bf16=stage)
            torch.cuda.synchronize()
            diff = (out_k.float() - out_p.float()).abs()
            n_diff = int((diff != 0).sum())
            err = max(err, float(diff.max()))
            check(bool(torch.isfinite(out_k.float()).all()), "finite trunk_int8 output")
            phase("kernel_check", kernel="trunk_int8", weights=weights, stage_bf16=stage,
                  batch=batch, block_games=block_size(batch, 16), differing=n_diff,
                  of=out_k.numel(), max_abs_diff=float(diff.max()))
            check(n_diff == 0, f"trunk_int8 (stage_bf16={stage}) == plain version at B={batch}")
    lp_k, v_k = fused8(feats)
    lp_p, v_p = fused8.heads(trunk_int8_plain(fused8.stem(feats), w, ws, b))
    check(torch.equal(lp_k, lp_p) and torch.equal(v_k, v_p),
          "FusedInference(int8) kernel == plain trunk")
    return err, fused8


def u32_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| of two uint32 tensors, as int64."""
    return ((a.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
            - (b.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)).abs()


def check_random_step(dev) -> float:
    """random_step against random_step_plain on the card with the same
    words, every ply to the end of every game: 4,096 games for each size and
    rule set, then the bench's 4,194,304 at 8x8; then play_random_games
    through the kernel against the plain loop on the CPU (see the module
    docstring). Returns the largest difference."""
    err = 0.0
    cases = [(size, rules, 4096) for size in (8, 6, 4) for rules in ("reference", "standard")]
    for size, rules, games in cases + [(8, "reference", RANDOM_GAMES)]:
        eng = get_engine(size, rules)
        s = eng.initial_state((games,), device=dev)
        packed = fused_step.pack_boards(s.me, s.opp)
        del s
        gen = torch.Generator(device=dev).manual_seed(size + games)
        plies, differing, live = 0, 0, True
        while live and plies <= 2 * size * size + 4:
            words = rs.draw_words(packed.shape[1:], gen)
            new_k, live_k = rs.random_step(packed, words, size, rules)
            new_p, live_p = rs.random_step_plain(packed, words, size, rules)
            d = u32_diff(new_k, new_p)
            differing += int((d != 0).sum()) + int((live_k != live_p).sum())
            err = max(err, float(d.max()), float((live_k - live_p).abs().max()))
            packed, live, plies = new_k, bool(live_k.any()), plies + 1
        phase("kernel_check", kernel="random_step", size=size, rules=rules, games=games,
              plies=plies, differing=differing, all_ended=not live)
        check(differing == 0 and not live,
              f"random_step == plain version, every ply, size {size} {rules}, {games} games")
        del packed, words, new_k, live_k, new_p, live_p, d
    s = get_engine(8).initial_state((16384,), device=dev)
    packed = fused_step.pack_boards(s.me, s.opp)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    drawn = []

    def draw(_):
        drawn.append(rs.draw_words(packed.shape[1:], gen))
        return drawn[-1]

    final_k, steps_k, plies_k = fused_step.play_random_games(packed, gen, words=draw)
    final_p, steps_p, plies_p = fused_step.play_random_games(
        packed.cpu(), None, words=lambda ply: drawn[ply].cpu())
    d = u32_diff(final_k.cpu(), final_p)
    err = max(err, float(d.max()))
    phase("kernel_check", what="play_random_games kernel vs the plain loop on the CPU",
          games=16384, steps=[steps_k, steps_p], plies=[plies_k, plies_p],
          boards_differing=int((d != 0).sum()))
    check(int((d != 0).sum()) == 0 and (steps_k, plies_k) == (steps_p, plies_p),
          "play_random_games through the kernel == the plain loop on the CPU")
    return err


def stub_weights(size: int, seed: int = 0) -> dict:
    """The deterministic stub network's weights: multiples of 1/16 and 1/64,
    so its logits and value are exact in float32 (the port half of
    tests/torch_stub_net.py, which imports JAX)."""
    rng = np.random.default_rng(seed)
    n_in, n_act = size * size * 3, size * size + 1
    return {"W": (rng.integers(-16, 17, (n_in, n_act)) / 16).astype(np.float32),
            "b": (rng.integers(-8, 9, n_act) / 16).astype(np.float32),
            "vw": (rng.integers(-8, 9, n_in) / 64).astype(np.float32),
            "vb": np.float32(0.125)}


def stub_net(weights: dict, device):
    """The stub on ``device``; its log-softmax is taken in float64 and
    rounded to float32, which the card and the CPU give bit for bit."""
    W, b, vw = (torch.from_numpy(weights[k]).to(device) for k in ("W", "b", "vw"))
    vb = float(weights["vb"])

    def net(x):
        f = x.reshape(x.shape[0], -1)
        d = f @ vw + vb
        log_p = torch.log_softmax((f @ W + b).to(torch.float64), dim=-1).to(torch.float32)
        return log_p, (d / (1 + d.abs()))[:, None]

    return net


def search_check(engine, feats: torch.Tensor, dev) -> None:
    """play_games on the card and on the CPU with the stub network: every
    trajectory field bit-identical (see the module docstring)."""
    weights = stub_weights(engine.size)
    out_c = stub_net(weights, dev)(feats)
    out_h = stub_net(weights, "cpu")(feats.cpu())
    check(all(torch.equal(a.cpu(), h) for a, h in zip(out_c, out_h)),
          "the stub's outputs on the card == CPU")
    # why float64: the same logits' float32 log-softmax, card vs CPU
    logits = feats.reshape(feats.shape[0], -1) @ torch.from_numpy(weights["W"]).to(dev)
    f32_diff = float((torch.log_softmax(logits, -1).cpu() - torch.log_softmax(logits.cpu(), -1))
                     .abs().max())
    trajs, seconds = [], []
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        trajs.append(play_games(engine, stub_net(weights, d), SEARCH_GAMES, SEARCH_SIMS,
                                dirichlet_epsilon=0.0, temperature_threshold=0, seed=SEED,
                                device=d))
        seconds.append(round(time.perf_counter() - t0, 3))
    card, host = trajs
    differing = [f for f in card._fields if not torch.equal(getattr(card, f).cpu(), getattr(host, f))]
    plies = [t for t in range(card.mask.shape[1])
             if not all(torch.equal(getattr(card, f)[:, t].cpu(), getattr(host, f)[:, t])
                        for f in ("me", "opp", "pi", "value", "mask"))]
    phase("search_check", games=SEARCH_GAMES, simulations=SEARCH_SIMS,
          log_softmax_f32_max_diff=f32_diff,
          plies=int(host.mask.any(dim=0).sum()), fields_differing=differing,
          first_diverging_plies=plies[:4], seconds_card_cpu=seconds)
    check(not differing, f"self-play on the card == CPU (differing: {differing})")


def arena_check(engine, dev) -> None:
    """Arena matches on the card and on the CPU with deterministic players:
    every game identical (see the module docstring); then the native
    alpha-beta player against Greedy on the card."""
    greedy = GreedyPlayer(engine)
    weights = stub_weights(engine.size)
    pairs = {"greedy_vs_greedy": lambda d: (greedy, greedy),
             "mcts_stub_vs_greedy": lambda d: (
                 MCTSPlayer(engine, stub_net(weights, d), num_simulations=SEARCH_SIMS), greedy)}
    for what, players in pairs.items():
        games, seconds = [], []
        for d in (dev, torch.device("cpu")):
            t0 = time.perf_counter()
            s = Arena(engine, device=d).play_matches(*players(d), ARENA_GAMES, seed=SEED)
            seconds.append(round(time.perf_counter() - t0, 3))
            games.append([(r.winner, r.player1_score, r.player2_score, r.num_moves)
                          for r in s.results])
        differing = sum(a != b for a, b in zip(*games))
        phase("arena_check", match=what, games=ARENA_GAMES, simulations=SEARCH_SIMS,
              p1_wins=sum(g[0] == 1 for g in games[0]), p1_losses=sum(g[0] == -1 for g in games[0]),
              avg_moves=float(np.mean([g[3] for g in games[0]])), games_differing=differing,
              seconds_card_cpu=seconds)
        check(len(games[0]) == ARENA_GAMES and differing == 0,
              f"{what}: every game on the card == CPU ({differing} differ)")
        check(all(g[1] + g[2] <= 64 and g[3] > 0 for g in games[0]), f"{what}: sane games")
    t0 = time.perf_counter()
    minimax = NativeMinimaxPlayer(engine, depth=2)
    build_s = time.perf_counter() - t0
    s = Arena(engine, device=dev).play_matches(minimax, greedy, 8, seed=SEED,
                                               opening_random_plies=4)
    phase("arena_check", match=f"{minimax.name} vs Greedy", games=8, opening_random_plies=4,
          wins=s.wins, losses=s.losses, draws=s.draws, avg_moves=s.avg_moves,
          build_and_load_s=round(build_s, 3), seconds=round(s.duration, 3))
    check(s.wins + s.losses + s.draws == 8 and s.avg_moves > 0, "minimax match played")


def gating_phase() -> int:
    """One gated iteration of the strong_8x8 recipe through int8_dxcat, and
    a reload of its checkpoint (see the module docstring). Returns the
    kernel's launches."""
    shutil.rmtree(SCRATCH, ignore_errors=True)
    cfg = json.loads(json.dumps(STRONG))
    cfg["paths"] = {"checkpoint_dir": str(SCRATCH / "models"), "log_dir": str(SCRATCH / "logs")}
    logs = []
    tr = trainer_lib.AlphaZeroTrainer(cfg, log_cb=logs.append)
    check(tr.device.type == "cuda" and tr.variant == "int8_dxcat" and tr.gating_enabled,
          "gated trainer on the card, int8_dxcat")
    forwards = {"self_play": 0, "gate_match": 0}
    counting, matches = ["self_play"], []
    make_net, gate_match, run_self_play = tr._net, tr._gate_match, tr.run_self_play

    def counted_net(model):
        net = make_net(model)

        def f(x):
            forwards[counting[0]] += 1
            return net(x)
        return f

    def timed_self_play(n, **kw):
        t0 = time.perf_counter()
        out = run_self_play(n, **kw)
        torch.cuda.synchronize()
        matches.append(("self_play", time.perf_counter() - t0, None))
        return out

    def timed_gate_match(seed):
        counting[0] = "gate_match"
        t0 = time.perf_counter()
        out = gate_match(seed)
        torch.cuda.synchronize()
        matches.append(("gate_match", time.perf_counter() - t0, out))
        return out

    tr._net, tr._gate_match, tr.run_self_play = counted_net, timed_gate_match, timed_self_play
    best_before = {k: t.clone() for k, t in tr.best.items()}
    torch.cuda.synchronize()
    for kernel in set(VARIANT_KERNEL.values()):
        kernel.launches = 0
    t0 = time.perf_counter()
    scalars = tr._train_iteration(0, tr.episodes_per_iter, tr.num_iterations, [], [])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = trunk_int8_dxcat.launches
    others = {k.__name__: k.launches for k in VARIANT_KERNEL.values() if k is not trunk_int8_dxcat}
    sp_s = dict((m[0], m[1]) for m in matches)["self_play"]
    _, gate_s, (win_rate, summary) = matches[-1]
    n_fwd = forwards["self_play"] + forwards["gate_match"]
    per_forward = launches_per_forward(trunk_int8_dxcat)
    check(launches > 0 and launches == per_forward * n_fwd,
          f"int8_dxcat launches {launches} == {per_forward} x forwards {n_fwd}")
    check(not any(others.values()), f"no other trunk kernel in the gated iteration ({others})")
    check(summary.wins + summary.losses + summary.draws == 40 and len(summary.results) == 40,
          "40 gate games")
    accepted = win_rate >= tr.gating_threshold
    check(any(m.startswith("gating @ iter 1:") and ("ADOPTED" in m) == accepted for m in logs),
          "the gating decision is logged")
    tr.close()  # flushes the metrics
    with open(SCRATCH / "logs" / "metrics.jsonl") as f:
        rows = {r["tag"]: r for r in map(json.loads, f) if r["tag"].startswith("Gating/")}
    check(rows.get("Gating/win_rate", {}).get("value") == win_rate
          and rows.get("Gating/accepted", {}).get("value") == float(accepted)
          and rows["Gating/accepted"]["step"] == 1, "the decision written as its two scalars")
    want = tr.model.state_dict() if accepted else best_before
    check(all(torch.equal(tr.best[k], want[k]) for k in want),
          "best == the candidate" if accepted else "best unchanged")
    path = SCRATCH / "models" / "checkpoint_iter_000001.pt"
    meta = json.loads(path.with_name(path.name + ".meta.json").read_text())
    check(path.is_file() and meta["has_best"], "checkpoint written with best")
    fresh = trainer_lib.AlphaZeroTrainer(cfg, log_cb=None)
    fresh.load_checkpoint(str(path))
    check(all(torch.equal(tr.best[k], fresh.best[k]) for k in tr.best)
          and all(torch.equal(t, fresh.model.state_dict()[k])
                  for k, t in tr.model.state_dict().items()),
          "the checkpoint reloads best and the candidate exactly")
    phase("gating", games=tr.episodes_per_iter, simulations=tr.num_simulations,
          variant=tr.variant, gate_games=len(summary.results), gate_simulations=tr.gating_sims,
          forwards=forwards, trunk_launches=launches, sgd_steps=tr.epochs_per_iter,
          loss_mean=scalars["Loss/train"], wins=summary.wins, losses=summary.losses,
          draws=summary.draws, win_rate=win_rate, adopted=accepted,
          self_play_s=round(sp_s, 3), sgd_s=round(scalars["Time/train"], 3),
          gate_match_s=round(gate_s, 3), checkpoint_s=round(tr.last_checkpoint_seconds, 3),
          checkpoint_mb=round(path.stat().st_size / 2 ** 20, 1),
          iteration_s=round(seconds, 3))
    fresh.close()
    shutil.rmtree(SCRATCH, ignore_errors=True)
    return launches


def captured(fn, argv: list):
    """``fn(argv)`` with what it prints captured: ``(result, text)``. On an
    exception the text's tail is printed first."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            result = fn(argv)
    except BaseException:
        print(out.getvalue()[-4000:], flush=True)
        raise
    return result, out.getvalue()


def cli_phase(engine, dev) -> None:
    """The port's CLI and scripts as a user runs them (see the module
    docstring): train from a YAML file through int8_dx3, resume, eval,
    play, export and reload, the engine benchmark."""
    shutil.rmtree(CLI_SCRATCH, ignore_errors=True)
    CLI_SCRATCH.mkdir(parents=True)
    seconds, counts = {}, {"forwards": 0}
    t0 = time.perf_counter()
    cut = config_with("run_flagship_r5.yaml", CLI_CUT)
    check((cut["model"]["num_blocks"], cut["model"]["num_filters"]) == (10, 128)
          and cut["system"]["self_play_net_variant"] == "int8_dx3",
          "configs/run_flagship_r5.yaml read: 10x128, int8_dx3")
    path = CLI_SCRATCH / "flagship_cut.yaml"
    path.write_text(to_yaml(cut))
    check(load_config(str(path)) == cut, "the cut copy reads back equal")
    seconds["config"] = time.perf_counter() - t0

    make_net = trainer_lib.AlphaZeroTrainer._net

    def counted_net(self, model):
        net = make_net(self, model)

        def f(x):
            counts["forwards"] += 1
            return net(x)
        return f

    def train(argv, what):
        for kernel in set(VARIANT_KERNEL.values()):
            kernel.launches = 0
        counts["forwards"] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer_lib.AlphaZeroTrainer._net = counted_net
        try:
            _, log = captured(cli.main, argv)
        finally:
            trainer_lib.AlphaZeroTrainer._net = make_net
        torch.cuda.synchronize()
        seconds[what] = time.perf_counter() - t
        launches, fwd = trunk_int8_dx3.launches, counts["forwards"]
        others = {k.__name__: k.launches for k in VARIANT_KERNEL.values()
                  if k is not trunk_int8_dx3}
        check(launches > 0 and launches == 2 * NUM_BLOCKS * fwd,
              f"cli {what}: int8_dx3 launches {launches} == 20 x forwards {fwd}")
        check(not any(others.values()), f"cli {what}: no other trunk kernel ({others})")
        check("self-heal" not in log, f"cli {what}: no self-heal line")
        return log, launches, fwd

    models = CLI_SCRATCH / "models"
    log, launches, fwd = train(["train", "--config", str(path)], "train")
    check(all((models / f"{n}.pt").is_file()
              for n in ("checkpoint_iter_000001", "checkpoint_iter_000002", "final_model")),
          "checkpoints of iterations 1 and 2 and final_model written")
    check("iter 2/2" in log, "two iterations logged")
    cut["training"]["num_iterations"] = 3
    path.write_text(to_yaml(cut))
    log, launches_r, fwd_r = train(["train", "--config", str(path), "--resume", "latest"],
                                   "resume")
    final = models / "final_model.pt"
    state = torch.load(final, map_location="cpu", weights_only=True)["train_state"]
    check("at iteration 2" in log and "iter 3/3" in log and "iter 1/" not in log
          and "iter 2/" not in log and state["iteration"] == 3
          and (models / "checkpoint_iter_000003.pt").is_file(),
          "resume starts at iteration 3 and ends with final_model at 3")

    cwd = Path.cwd()
    t = time.perf_counter()
    try:
        os.chdir(CLI_SCRATCH)  # eval --save-results writes data/eval/ under the cwd
        captured(cli.main, ["eval", "--checkpoint", str(final), "--games", "8",
                            "--simulations", "8", "--minimax-depth", "2", "--save-results"])
    finally:
        os.chdir(cwd)
    seconds["eval"] = time.perf_counter() - t
    saved = sorted((CLI_SCRATCH / "data" / "eval").glob("eval_*.json"))
    check(len(saved) == 1, "eval --save-results wrote one file")
    results = json.loads(saved[0].read_text())["results"]
    check(set(results) == {"Random", "Greedy", "Minimax(d2/e12)"}
          and not any("error" in r for r in results.values())
          and all(r["wins"] + r["losses"] + r["draws"] == 8 for r in results.values()),
          f"eval: every opponent has a result, none an error ({results})")

    def first_legal(prompt: str) -> str:
        return prompt[prompt.index("[") + 1:].split("]")[0].split(",")[0]

    t = time.perf_counter()
    cli.input = first_legal
    try:
        _, played = captured(cli.main, ["play", "--checkpoint", str(final), "--simulations", "4"])
    finally:
        del cli.input
    seconds["play"] = time.perf_counter() - t
    check("game over:" in played, "play reaches game over")

    t = time.perf_counter()
    exports = {}
    for fmt, suffix in (("reference-pt", ".pt"), ("torchscript", ".ts.pt"),
                        ("stablehlo", ".pt2")):
        exports[fmt] = CLI_SCRATCH / f"export_{fmt}{suffix}"
        captured(cli.main, ["export", "--checkpoint", str(final), "--out", str(exports[fmt]),
                 "--format", fmt, "--batch-size", str(CLI_EXPORT_BATCH)])
    seconds["export"] = time.perf_counter() - t
    t = time.perf_counter()
    net = MCTSPlayer.from_checkpoint(str(final), device=dev).model
    x = engine.features(random_positions(engine, CLI_EXPORT_BATCH, 30,
                                         np.random.default_rng(SEED), dev))
    with torch.no_grad():
        want = net(x, train=False, compute_dtype=torch.float32)
        sd = torch.load(exports["reference-pt"], map_location=dev,
                        weights_only=True)["model_state_dict"]
        ref = OthelloResNet(*infer_architecture(sd)).to(dev)
        ref.load_state_dict(sd)
        got = {"reference-pt": ref(x, train=False, compute_dtype=torch.float32),
               "torchscript": torch.jit.load(str(exports["torchscript"]), map_location=dev)(
                   x.permute(0, 3, 1, 2)),
               "stablehlo": load_exported(str(exports["stablehlo"]), dev)(x)}
    export_err = {}
    for fmt, (lp, v) in got.items():
        check(lp.device.type == "cuda" and lp.shape == want[0].shape and v.shape == want[1].shape,
              f"export {fmt}: outputs on the card, shapes {tuple(lp.shape)}, {tuple(v.shape)}")
        export_err[fmt] = max(float((lp - want[0]).abs().max()), float((v - want[1]).abs().max()))
    check(torch.equal(got["reference-pt"][0], want[0]) and torch.equal(got["reference-pt"][1],
                                                                       want[1]),
          "reference-pt reloads bit for bit")
    check(export_err["torchscript"] <= 1e-5 and export_err["stablehlo"] <= 1e-5,
          f"torchscript and torch.export within 1e-5 ({export_err})")
    seconds["export_check"] = time.perf_counter() - t

    t = time.perf_counter()
    out, _ = captured(benchmark.main, ["--games", "2000", "--batch", "4096", "--repeats", "1"])
    seconds["benchmark"] = time.perf_counter() - t
    check(out["native"] is not None and out["native"]["passed"], "native playouts pass 5,000 games/s")
    check(out["batched"]["value"] > 0 and out["batched"]["batch"] == 4096, "batched engine section")
    phase("cli", config="configs/run_flagship_r5.yaml",
          games=cut["training"]["self_play_episodes_per_iter"],
          simulations=cut["mcts"]["num_simulations"],
          sgd_steps=cut["training"]["train_epochs_per_iter"], forwards=fwd, trunk_launches=launches, resume_forwards=fwd_r,
          resume_trunk_launches=launches_r, eval_results=results,
          export_max_abs_diff=export_err, export_batch=CLI_EXPORT_BATCH,
          native_games_per_s=round(out["native"]["games_per_sec"], 1),
          batched_games_per_s=out["batched"]["value"],
          seconds={k: round(v, 3) for k, v in seconds.items()},
          total_s=round(time.perf_counter() - t0, 3))
    shutil.rmtree(CLI_SCRATCH, ignore_errors=True)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def step_inputs(engine, dev):
    """The distributed SGD check's global batch: 1024 positions after 30
    random plies, pi and values, from a numpy seed (the same on every rank)."""
    rng = np.random.default_rng(SEED + 2)
    feats = engine.features(random_positions(engine, DIST_STEP_BATCH, 30, rng, dev))
    pi = rng.random((DIST_STEP_BATCH, engine.num_actions)).astype(np.float32)
    pi /= pi.sum(-1, keepdims=True)
    tv = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (DIST_STEP_BATCH, 1))
    return feats, torch.from_numpy(pi).to(dev), torch.from_numpy(tv).to(dev)


def sgd_step(feats, pi, tv, dev):
    """One f32 SGD step at 10x128 from the trainer's initial weights (the
    configuration of ``train_step_check``): the new state dict on the CPU
    and the loss. Under a process group, the rank's share of a global
    batch."""
    cfg = {"training": {"lr": 0.006, "momentum": 0.9, "weight_decay": 1e-4}}
    m = OthelloResNet(NUM_BLOCKS, NUM_FILTERS)
    m.load_state_dict(from_jax_variables(init_train_variables(NUM_BLOCKS, NUM_FILTERS, SEED + 1)))
    m.to(dev)
    state = trainer_lib.TrainState(m, trainer_lib.make_optimizer(m, cfg))
    metrics = trainer_lib.train_on_batch(state, feats, pi, tv, trainer_lib.make_lr_schedule(cfg),
                                         torch.float32)
    return {k: t.cpu() for k, t in m.state_dict().items()}, float(metrics["loss"])


def distributed_worker(rank: int, port: int, outdir: str) -> int:
    """One rank of phase ``distributed`` (see the module docstring): joins
    the gloo group through ``cli train --coordinator``, then runs the gated
    iteration and the SGD step in it; writes ``result_{rank}.json``."""
    import functools

    from othello_reinforcement_learning_test_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # two ranks share the one card, which NCCL refuses: gloo, by the Python
    # argument the CLI leaves at its default
    mesh.initialize_distributed = functools.partial(mesh.initialize_distributed,
                                                    backend="gloo")
    out = DIST_SCRATCH / outdir
    seconds, forwards, kept = {}, [0], []
    cls = trainer_lib.AlphaZeroTrainer
    originals = {name: getattr(cls, name) for name in
                 ("_net", "run_self_play", "_gate_match", "save_checkpoint", "train")}
    steps = trainer_lib.train_steps

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return run

    def counted_net(self, model):
        net = originals["_net"](self, model)

        def f(x):
            forwards[0] += 1
            return net(x)
        return f

    def keep(self, *a, **kw):
        kept.append(self)
        return originals["train"](self, *a, **kw)

    cls._net, cls.train = counted_net, keep
    cls.run_self_play = timed("self_play", originals["run_self_play"])
    cls._gate_match = timed("gate_match", originals["_gate_match"])
    cls.save_checkpoint = timed("checkpoint", originals["save_checkpoint"])
    trainer_lib.train_steps = timed("sgd", steps)
    result = {"rank": rank}

    def reset():
        seconds.clear()
        forwards[0] = 0
        for kernel in set(VARIANT_KERNEL.values()):
            kernel.launches = 0

    # 1. cli train, 2 iterations through int8_dx3
    reset()
    t = time.perf_counter()
    _, log = captured(cli.main, ["train", "--config", str(DIST_SCRATCH / "flagship_cut.yaml"),
                                 "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                                 str(DIST_RANKS), "--process-id", str(rank)])
    tr = kept[-1]
    result["train"] = {
        "seconds": {k: round(v, 3) for k, v in seconds.items()},
        "total_s": round(time.perf_counter() - t, 3), "forwards": forwards[0],
        "launches": {k.__name__: k.launches for k in set(VARIANT_KERNEL.values())},
        "params": digest(tr.model.state_dict().values()),
        "buffer_filled": tr.buffer.filled, "iteration": tr.state.iteration,
        "self_heal": "self-heal" in log,
        "up": f"distributed: process {rank}/{DIST_RANKS} up" in log,
        "device": str(tr.device), "backend": torch.distributed.get_backend()}

    # 2. one gated strong_8x8 iteration through int8_dxcat in the same group
    cfg = json.loads(json.dumps(STRONG))
    cfg["paths"] = {"checkpoint_dir": str(DIST_SCRATCH / "strong" / "models"),
                    "log_dir": str(DIST_SCRATCH / "strong" / "logs")}
    cfg["system"]["mesh_devices"] = DIST_RANKS
    logs = []
    tr = trainer_lib.AlphaZeroTrainer(cfg, log_cb=logs.append)
    gates = []
    gate_match = tr._gate_match
    tr._gate_match = lambda seed: gates.append(gate_match(seed)) or gates[-1]
    reset()
    t = time.perf_counter()
    tr._train_iteration(0, tr.episodes_per_iter, tr.num_iterations, [], [])
    win_rate, summary = gates[-1]
    result["gated"] = {
        "seconds": {k: round(v, 3) for k, v in seconds.items()},
        "total_s": round(time.perf_counter() - t, 3), "forwards": forwards[0],
        "launches": {k.__name__: k.launches for k in set(VARIANT_KERNEL.values())},
        "params": digest(tr.model.state_dict().values()),
        "best": digest(tr.best[k] for k in sorted(tr.best)),
        "win_rate": win_rate, "wld": [summary.wins, summary.losses, summary.draws],
        "gate_games": len(summary.results),
        "adopted": win_rate >= tr.gating_threshold,
        "self_heal": any("self-heal" in m for m in logs)}
    tr.close()

    # 3. the 2-rank SGD step on the rank's half of the global batch
    feats, pi, tv = step_inputs(tr.engine, tr.device)
    rows = mesh.local_slice(DIST_STEP_BATCH)
    sd, loss = sgd_step(feats[rows], pi[rows], tv[rows], tr.device)
    torch.save(sd, out / f"sgd_{rank}.pt")
    result["sgd"] = {"loss": loss, "params": digest(sd.values())}
    (out / f"result_{rank}.json").write_text(json.dumps(result))
    torch.distributed.destroy_process_group()
    return 0


def distributed_phase(engine, dev) -> None:
    """NCCL at world size 1 on the card, then two gloo ranks on the card
    through the CLI (see the module docstring)."""
    from othello_reinforcement_learning_test_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    # 1. NCCL, world size 1: each collective of the port on CUDA tensors
    mesh.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    check(torch.distributed.get_backend() == "nccl", "the CUDA process group is NCCL")
    traj = play_games(engine, stub_net(stub_weights(8), dev), 16, 2, add_noise=True, seed=SEED,
                      device=dev)
    gathered = mesh.all_gather_leading(traj)
    check(all(torch.equal(a, b) for a, b in zip(gathered, traj)),
          "all_gather_leading of a trajectory at world size 1 is the trajectory")
    m = OthelloResNet(1, 16).to(dev)
    x = engine.features(random_positions(engine, 8, 10, np.random.default_rng(SEED), dev))
    log_p, value = m(x, train=True, compute_dtype=torch.float32)
    (log_p.sum() + value.sum()).backward()
    grads = [p.grad.clone() for p in m.parameters()]
    mesh.all_reduce_mean_grads(m)
    check(all(torch.equal(g, p.grad) for g, p in zip(grads, m.parameters())),
          "the gradient all-reduce at world size 1 keeps every gradient")
    moments = torch.randn(2, 128, device=dev, dtype=torch.float32, requires_grad=True)
    mean = mesh.global_mean(moments)
    mean.backward(torch.ones_like(mean))
    check(torch.equal(mean, moments) and torch.equal(moments.grad, torch.ones_like(moments)),
          "the BatchNorm moment all-reduce at world size 1: the moments and their gradient")
    b = torch.arange(10, device=dev)
    check(torch.equal(mesh.broadcast(b.clone()), b), "broadcast at world size 1")
    torch.distributed.destroy_process_group()
    nccl_s = time.perf_counter() - t0

    # 2. two ranks over gloo on the one card, each running the CLI
    shutil.rmtree(DIST_SCRATCH, ignore_errors=True)
    DIST_SCRATCH.mkdir(parents=True)
    cut = config_with("run_flagship_r5.yaml", DIST_CUT)
    check((cut["model"]["num_blocks"], cut["model"]["num_filters"]) == (10, 128)
          and cut["system"]["self_play_net_variant"] == "int8_dx3",
          "configs/run_flagship_r5.yaml read: 10x128, int8_dx3")
    (DIST_SCRATCH / "flagship_cut.yaml").write_text(to_yaml(cut))
    (DIST_SCRATCH / "out").mkdir()
    port = free_port()
    t1 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--distributed-rank",
                               str(rank), str(port), "out"], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(DIST_RANKS)]
    outs = []
    try:
        for p in procs:
            left = DIST_TIMEOUT_S - (time.perf_counter() - t1)
            outs.append(p.communicate(timeout=max(left, 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t1
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(text[-6000:], flush=True)
        check(p.returncode == 0, f"distributed rank {rank} exited {p.returncode}")
    res = [json.loads((DIST_SCRATCH / "out" / f"result_{r}.json").read_text())
           for r in range(DIST_RANKS)]
    for r in res:
        tr_, g = r["train"], r["gated"]
        check(tr_["up"] and tr_["backend"] == "gloo" and tr_["device"].startswith("cuda"),
              f"rank {r['rank']}: the CLI started a gloo group on the card")
        check(tr_["iteration"] == 2 and not tr_["self_heal"] and not g["self_heal"],
              f"rank {r['rank']}: 2 iterations, no self-heal line")
        for run, kernel in ((tr_, trunk_int8_dx3), (g, trunk_int8_dxcat)):
            n, fwd = run["launches"][kernel.__name__], run["forwards"]
            others = {k: v for k, v in run["launches"].items() if k != kernel.__name__}
            check(n > 0 and n == launches_per_forward(kernel) * fwd and not any(others.values()),
                  f"rank {r['rank']}: {kernel.__name__} launches {n} == "
                  f"{launches_per_forward(kernel)} x forwards {fwd}, no other trunk ({others})")
        check(g["gate_games"] == 40 and sum(g["wld"]) == 40, f"rank {r['rank']}: 40 gate games")
    a, b = res
    check(a["train"]["params"] == b["train"]["params"]
          and a["train"]["buffer_filled"] == b["train"]["buffer_filled"],
          "both ranks end cli train with equal parameters and buffer fill")
    check(all(a["gated"][k] == b["gated"][k] for k in ("params", "best", "win_rate", "wld",
                                                       "adopted")),
          "both ranks end the gated iteration equal and make the same decision")
    check(a["sgd"]["params"] == b["sgd"]["params"] and a["sgd"]["loss"] == b["sgd"]["loss"],
          "both ranks end the SGD step equal")

    # 3. the 2-rank SGD step against the single-process full-batch step
    want, loss = sgd_step(*step_inputs(engine, dev), dev)
    got = torch.load(DIST_SCRATCH / "out" / "sgd_0.pt", weights_only=True)

    def worst(names):  # largest |2 ranks - 1 process| / (atol 1e-6 + rtol 1e-4 * |1 process|)
        return max(float(((got[k].double() - want[k].double()).abs()
                          / (1e-6 + 1e-4 * want[k].double().abs())).max()) for k in names)

    floats = [k for k in want if want[k].is_floating_point()]
    params_worst = worst([k for k in floats if "running" not in k])
    stats_worst = worst([k for k in floats if "running" in k])
    loss_diff = abs(a["sgd"]["loss"] / loss - 1)
    phase("distributed", nccl={"world_size": 1, "backend": "nccl", "seconds": round(nccl_s, 3)},
          ranks=DIST_RANKS, backend="gloo", config="configs/run_flagship_r5.yaml",
          games_per_rank=DIST_CUT["training"]["self_play_episodes_per_iter"] // DIST_RANKS,
          simulations=DIST_CUT["mcts"]["num_simulations"],
          batch_per_rank=DIST_CUT["training"]["batch_size"] // DIST_RANKS,
          train=[{k: r["train"][k] for k in ("seconds", "total_s", "forwards", "buffer_filled")}
                 | {"int8_dx3_launches": r["train"]["launches"]["trunk_int8_dx3"]} for r in res],
          gated=[{k: r["gated"][k] for k in ("seconds", "total_s", "forwards", "wld",
                                             "win_rate", "adopted")}
                 | {"int8_dxcat_launches": r["gated"]["launches"]["trunk_int8_dxcat"]}
                 for r in res],
          sgd_loss_rel_diff=loss_diff, sgd_params_worst_over_tolerance=params_worst,
          sgd_stats_worst_over_tolerance=stats_worst, ranks_s=round(ranks_s, 3),
          total_s=round(time.perf_counter() - t0, 3))
    check(loss_diff <= 1e-4, "2-rank SGD loss == the single-process step's (rtol 1e-4)")
    check(params_worst <= 1.0 and stats_worst <= 1.0,
          "2-rank SGD step == the single-process full-batch step (rtol 1e-4, atol 1e-6)")
    shutil.rmtree(DIST_SCRATCH, ignore_errors=True)


def session_parity(engine, dev) -> dict:
    """Part (a) of phase ``frontends``: one stub-network session on the card
    and one on the CPU through a whole game, every state and the hint
    identical."""
    weights = stub_weights(engine.size)
    sessions = []
    for d in (dev, torch.device("cpu")):
        gm = GameManager(engine=engine, model_dir=str(FRONT_SCRATCH), device=d)
        gm._player = MCTSPlayer(engine, stub_net(weights, d), num_simulations=FRONT_STUB_SIMS)
        gm.set_simulations(FRONT_STUB_SIMS)
        sessions.append(gm)
    card, host = sessions
    check(card.board.me.device.type == "cuda", "the card session's board is on the card")
    rng = np.random.default_rng(SEED + 3)
    plies, hint, undone = 0, None, False
    t0 = time.perf_counter()
    while True:
        state = card.state_dict()
        check(state == host.state_dict(), f"session state on the card == CPU at ply {plies}")
        if state["is_game_over"]:
            break
        if plies == FRONT_UNDO_AT and not undone:
            check(card.undo() == host.undo() == (True, None), "undo on both")
            undone = True
            continue
        if plies == FRONT_HINT_EVERY:
            hint = card.hint()
            check(hint == host.hint() and bool(hint), "the hint on the card == CPU")
        if state["current_player"] == 1:
            move = int(rng.choice(state["legal_moves"]))
            check(card.make_move(move) == host.make_move(move) == (True, None), "human move")
        else:
            check(card.execute_ai_move() == host.execute_ai_move() == (True, None), "AI move")
        plies += 1
    return {"plies": plies, "winner": state["winner"], "hint": hint,
            "seconds": round(time.perf_counter() - t0, 3)}


def http_json(base: str, path: str, method: str = "GET", body=None):
    """One request as the JS client's ``_fetch`` makes it: (status, JSON)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, method=method,
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def web_game(engine, dev, model_path: str) -> dict:
    """Part (b) of phase ``frontends``: the stdlib server over a CUDA
    session, driven over HTTP as the JS client drives it."""
    import urllib.request

    gm = GameManager(model_dir=str(FRONT_SCRATCH / "models"), device=dev)
    port = free_port()
    server, _ = make_server("127.0.0.1", port, gm=gm)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"
    try:
        for path in STATIC_FILES:
            with urllib.request.urlopen(base + path, timeout=60) as resp:
                check(resp.status == 200 and len(resp.read()) > 0, f"GET {path}")
        status, models = http_json(base, "/api/ai/models")
        check(status == 200 and models["models"] == [model_path], f"the model list: {models}")
        check(http_json(base, "/api/ai/load-model", "POST", {"path": model_path})
              == (200, {"success": True, "error": None}), "load-model")
        player = gm._player
        forwards = [0]
        net = player.net

        def counted(x):
            forwards[0] += 1
            return net(x)

        player.net = counted
        check(all(p.device.type == "cuda" for p in player.model.parameters()),
              "the network's parameters on the card")
        check(http_json(base, "/api/ai/simulations", "PUT", {"num_simulations": FRONT_SIMS})
              == (200, {"num_simulations": FRONT_SIMS}), "simulations 100")
        check(http_json(base, "/api/game/new", "POST")[0] == 200, "new game")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_mib = torch.cuda.memory_allocated() / 2**20  # the script's tensors and the model
        rng = np.random.default_rng(SEED + 4)
        actions, ai_s, max_s, hint_s, state_ms = [], [], [], [], []
        plies = passes = 0
        undone = False
        while True:
            t0 = time.perf_counter()
            status, state = http_json(base, "/api/game/state")
            state_ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, "GET state")
            if state["is_game_over"]:
                break
            legal = state["legal_moves"]
            passes += legal == [engine.pass_action]
            if plies and plies % FRONT_HINT_EVERY == 0 and len(hint_s) < plies // FRONT_HINT_EVERY:
                t0 = time.perf_counter()
                status, hint = http_json(base, "/api/game/hint")
                hint_s.append(time.perf_counter() - t0)
                evals = {int(k): v for k, v in hint["evaluations"].items()}
                check(status == 200 and hint["num_simulations"] == max(10, gm.ai_simulations // 2)
                      and set(evals) <= set(legal) and all(0 <= v <= 100 for v in evals.values()),
                      f"hint at ply {plies}: {hint}")
            if plies == FRONT_UNDO_AT and not undone:
                status, res = http_json(base, "/api/game/undo", "POST")
                check(status == 200 and res["success"], "undo")
                actions.pop()
                undone = True
                continue
            if state["current_player"] == 1:
                move = int(rng.choice(legal))
                status, res = http_json(base, "/api/game/move", "POST", {"position": move})
                check(status == 200 and res["success"], f"human move {move}")
                actions.append(move)
            else:
                sims = FRONT_MAX_SIMS if plies >= FRONT_MAX_AT and not max_s else FRONT_SIMS
                if sims != gm.ai_simulations:
                    http_json(base, "/api/ai/simulations", "PUT", {"num_simulations": sims})
                before = forwards[0]
                t0 = time.perf_counter()
                check(http_json(base, "/api/game/ai-move", "POST")
                      == (200, {"success": True, "error": None}), "ai-move")
                while True:
                    time.sleep(0.05)
                    status, st = http_json(base, "/api/game/ai-status")
                    if not st["is_thinking"]:
                        break
                (max_s if sims == FRONT_MAX_SIMS else ai_s).append(time.perf_counter() - t0)
                check(st["error"] is None and st["last_ai_move"] in legal,
                      f"AI move {st['last_ai_move']} legal ({legal})")
                check(forwards[0] - before == 1 + sims,
                      f"forwards of an AI move {forwards[0] - before} == 1 + {sims}")
                actions.append(st["last_ai_move"])
                if sims != FRONT_SIMS:
                    http_json(base, "/api/ai/simulations", "PUT", {"num_simulations": FRONT_SIMS})
            plies += 1
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        # where an AI move's time goes: a search at B=1 on a position 20
        # plies in, profiled (SIMS simulations: the per-simulation figures
        # of a move, at a quarter of its profiler events), and the
        # network's forward alone at B=1
        board = random_positions(engine, 1, 20, np.random.default_rng(SEED + 5), dev)
        feats = engine.features(board)
        search = {"simulations": SIMS, **profile_search(engine, net, board)}
        forward_ms = time_ms(lambda: net(feats), reps=50)
        check(all(t.device.type == "cuda" for t in gm.board), "the session's board on the card")
        replay = engine.initial_state((1,))
        for a in actions:
            replay, ok = engine.step(replay, torch.tensor([a]))
            check(bool(ok[0]), f"replayed action {a} valid on the CPU engine")
        check(all(torch.equal(a.cpu(), b) for a, b in zip(gm.board, replay)),
              "the final board == the CPU engine replaying the actions")
        check(bool(engine.is_terminal(replay)[0]) and state["winner"] in (-1, 0, 1), "game over")
        check(len(max_s) == 1 and len(hint_s) >= 5 and undone, "a 500-simulation move, hints, undo")
        return {"plies": plies, "passes": passes, "ai_moves": len(ai_s) + 1,
                "black": state["black_count"], "white": state["white_count"],
                "winner": state["winner"],
                "ai_move_s_100": {"first": round(ai_s[0], 4), "median": round(float(np.median(ai_s)), 4),
                                  "max": round(max(ai_s), 4)},
                "ai_move_s_500": round(max_s[0], 4),
                "hint_s_50": {"median": round(float(np.median(hint_s)), 4),
                              "max": round(max(hint_s), 4), "count": len(hint_s)},
                "state_ms_median": round(float(np.median(state_ms)), 3),
                "forwards_per_ai_move": 1 + FRONT_SIMS, "forwards": forwards[0],
                "cuda_mib_at_start": round(start_mib, 1), "peak_cuda_mib": round(peak_mib, 1),
                "search_b1": search, "forward_ms_b1": forward_ms}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def gui_check(dev, model_path: str) -> dict:
    """Part (c) of phase ``frontends``: the port's Tk app on the card under
    the repository's headless toolkit (``tests/fake_tk.py``)."""
    sys.path.insert(0, str(REPO / "tests"))
    import fake_tk

    saved = {k: sys.modules.get(k) for k in ("tkinter", "tkinter.filedialog", "tkinter.messagebox")}
    sys.modules.update({"tkinter": fake_tk, "tkinter.filedialog": fake_tk.filedialog,
                        "tkinter.messagebox": fake_tk.messagebox})
    gui_modules = [k for k in sys.modules if ".apps.gui" in k]
    for k in gui_modules:
        del sys.modules[k]
    try:
        from othello_reinforcement_learning_test_tpu_torch.apps.gui.app import OthelloApp

        root = fake_tk.Tk()
        app = OthelloApp(root, model_path=model_path, model_dir=str(FRONT_SCRATCH / "models"),
                         device=dev)
        gm = app.gm
        check(gm.state_dict()["model_path"] == model_path
              and next(gm._player.model.parameters()).device.type == "cuda"
              and gm.board.me.device.type == "cuda", "the GUI's session and network on the card")

        def joined(action) -> float:
            before = set(threading.enumerate())
            t0 = time.perf_counter()
            action()
            for t in set(threading.enumerate()) - before:
                t.join(timeout=120)
                check(not t.is_alive(), "the GUI's worker thread ended")
            return time.perf_counter() - t0

        def kinds():
            return [k for k, _, _ in app.board_ui.canvas.items]

        cell = app.board_ui.cell
        click_s = joined(lambda: app.board_ui.canvas.event_generate(
            "<Button-1>", x=3 * cell + 5, y=2 * cell + 5))  # D3, then the AI's reply
        state = gm.state_dict()
        check(state["move_count"] == 2 and state["last_ai_move"] is not None
              and not state["is_ai_thinking"], f"a click and the AI's reply: {state['move_count']}")
        stones = state["black_count"] + state["white_count"]
        ovals = [kw for k, _, kw in app.board_ui.canvas.items if k == "oval"]
        dots = sum(m < 64 for m in state["legal_moves"])
        check(kinds().count("line") == 18 and len(ovals) == stones + dots + 1
              and sum(kw.get("width") == 3 for kw in ovals) == 1,
              "the board drawn: grid, stones, legal dots, the last-move marker")
        buttons = {b: getattr(app, b).cget("state")
                   for b in ("btn_undo", "btn_ai", "btn_hint", "btn_pass")}
        check(buttons == {"btn_undo": "normal", "btn_ai": "normal", "btn_hint": "normal",
                          "btn_pass": "disabled"}, f"button states {buttons}")
        hint_s = joined(app.btn_hint.invoke)
        texts = [kw["text"] for k, _, kw in app.board_ui.canvas.items if k == "text"]
        check(bool(app._evals) and set(app._evals) <= set(state["legal_moves"])
              and len(texts) == len(app._evals)
              and app.info.message_var.get() == f"hint ({len(app._evals)} moves)",
              f"the hint overlay: {app._evals}")
        root.destroy()
        return {"click_and_reply_s": round(click_s, 4), "hint_s": round(hint_s, 4),
                "draw_ops": len(kinds()), "hint_moves": len(texts)}
    finally:
        for k in [k for k in sys.modules if ".apps.gui" in k]:
            del sys.modules[k]
        for k, mod in saved.items():
            if mod is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = mod
        sys.path.remove(str(REPO / "tests"))


def frontends_phase(engine, dev) -> None:
    """The web session, the stdlib server and the Tk app on the card (see
    the module docstring)."""
    t0 = time.perf_counter()
    shutil.rmtree(FRONT_SCRATCH, ignore_errors=True)
    (FRONT_SCRATCH / "models").mkdir(parents=True)
    kernels = set(VARIANT_KERNEL.values()) | {rs.random_step}
    for kernel in kernels:
        kernel.launches = 0
    parity = session_parity(engine, dev)
    # the trained flagship r5 network, its file and config sidecar as committed
    src = trained.checkpoint("flagship_r5")
    model_path = str(FRONT_SCRATCH / "models" / Path(src).name)
    for suffix in ("", ".config.json"):
        shutil.copyfile(src + suffix, model_path + suffix)
    web = web_game(engine, dev, model_path)
    gui = gui_check(dev, model_path)
    launched = {k.__name__: k.launches for k in kernels if k.launches}
    phase("frontends", session_card_vs_cpu=parity, web=web, gui=gui,
          kernel_launches=launched, total_s=round(time.perf_counter() - t0, 3))
    check(not launched, f"no kernel on the frontends' path ({launched})")
    shutil.rmtree(FRONT_SCRATCH, ignore_errors=True)


def legal_top(log_probs: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Each position's most probable legal action."""
    return torch.where(legal, log_probs, -torch.inf).argmax(-1)


def check_trained_kernels(model, feats, weights: str) -> dict:
    """The gates of the seeded weights on a trained network, at
    TRAINED_BATCHES: int8_dx3, trunk_int8 (both stage_bf16 settings),
    int8_m9, int8_patch, int8_flat and int8_dxcat (also its repeated
    forwards) bit for bit against their plain versions and their
    forwards equal to the plain trunk's; matmul9 and wide equal to their 20
    convs, each conv within its bar, the forward within probs 0.03 / value
    0.05 or, past that, twice the drift of two correct f32 orders of the
    plain version (:func:`forward_bars`). Returns {kernel name: largest
    difference}."""
    at = TRAINED_BATCHES
    errs = {"trunk_int8_dx3": check_int8_dx3(FusedInference(model, variant="int8_dx3"),
                                             feats, weights, at)[0],
            "trunk_int8": check_trunk_int8(model, feats, weights, at)[0],
            "trunk_matmul9": check_matmul9(FusedInference(model, variant="matmul9"), feats,
                                           weights, True, witness_bars=True, batches=at),
            "trunk_wide": check_wide(FusedInference(model, variant="wide"), feats, weights,
                                     True, witness_bars=True, batches=at)}
    for variant, (err, _) in check_int8_variants(model, feats, weights, at).items():
        errs[INT8_VARIANTS[variant][0].__name__] = err
    return errs


def variants_vs_bf16(player, feats, legal, name: str) -> dict:
    """Each of the ten FusedInference variants on ``player``'s network
    against its plain bf16 forward (what the player plays through) at
    TRAINED_BATCHES: top legal move agreement >= TRAINED_AGREEMENT, value
    correlation > TRAINED_VALUE_CORR; each kernel launched
    launches_per_forward a forward and no other (int8_xla: none)."""
    kernels = set(VARIANT_KERNEL.values())
    rows = {}
    for batch in TRAINED_BATCHES:
        x, lg = feats[:batch], legal[:batch]
        lp_ref, v_ref = player.net(x)
        top_ref = legal_top(lp_ref, lg)
        for variant in PORTED_VARIANTS:
            fused = FusedInference(player.model, variant=variant)
            for k in kernels:
                k.launches = 0
            lp, v = fused(x)
            torch.cuda.synchronize()
            launched = {k.__name__: k.launches for k in kernels if k.launches}
            kernel = VARIANT_KERNEL.get(variant)
            want = {kernel.__name__: launches_per_forward(kernel)} if kernel else {}
            agree = float((legal_top(lp, lg) == top_ref).float().mean())
            corr = float(torch.corrcoef(torch.stack([v[:, 0], v_ref[:, 0]]))[0, 1])
            rows.setdefault(variant, {})[batch] = {
                "agreement": agree, "value_corr": corr,
                "max_abs_diff_probs": float((lp.exp() - lp_ref.exp()).abs().max()),
                "max_abs_diff_value": float((v - v_ref).abs().max()), "launches": launched}
            check(bool(torch.isfinite(lp).all() and torch.isfinite(v).all()),
                  f"{name} {variant}: finite forward at B={batch}")
            check(launched == want, f"{name} {variant}: launches {launched}, want {want}")
            check(agree >= TRAINED_AGREEMENT and corr > TRAINED_VALUE_CORR,
                  f"{name} {variant} vs the bf16 forward at B={batch}: agreement {agree} "
                  f"(>= {TRAINED_AGREEMENT}), value correlation {corr} (> {TRAINED_VALUE_CORR})")
    return rows


def trained_match(engine, dev) -> dict:
    """Flagship r5 (the plain bf16 forward, as ``benchmark_ai`` plays it)
    against Greedy through ``Arena.play_matches`` at the protocol of its JAX
    record in the manifest (50 games, 4 random opening plies, colours
    alternating) at TRAINED_MATCH_SIMS simulations: at least
    TRAINED_MATCH_WINS wins; no kernel on this path."""
    name, key = TRAINED_MATCH_RECORD
    rec = next(r for r in trained.records(name, "Greedy") if r["key"] == key)
    player = MCTSPlayer.from_checkpoint(trained.checkpoint(name),
                                        num_simulations=TRAINED_MATCH_SIMS, device=dev)
    kernels = set(VARIANT_KERNEL.values())
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = Arena(engine, device=dev).play_matches(player, GreedyPlayer(engine), rec["games"], SEED,
                                               opening_random_plies=rec["opening_random_plies"])
    seconds = time.perf_counter() - t0
    launched = {k.__name__: k.launches for k in kernels if k.launches}
    fields = {"match": f"{name} vs Greedy", "games": rec["games"],
              "simulations": TRAINED_MATCH_SIMS,
              "opening_random_plies": rec["opening_random_plies"], "wins": s.wins,
              "losses": s.losses, "draws": s.draws, "avg_score": s.avg_score,
              "avg_moves": s.avg_moves, "seconds": round(seconds, 3),
              "seconds_at_record_simulations": TRAINED_MATCH_S_AT_RECORD,
              "jax_record": f"{rec['wins']}-{rec['losses']}-{rec['draws']} at "
                            f"{rec['simulations']} simulations ({rec['file']}, {rec['key']})",
              "bar_wins": TRAINED_MATCH_WINS}
    phase("trained", **fields)
    check(not launched, f"no kernel in the bf16 match ({launched})")
    check(s.wins + s.losses + s.draws == rec["games"], "every game played")
    check(s.wins >= TRAINED_MATCH_WINS, f"flagship r5 wins {s.wins} of {rec['games']} against "
          f"Greedy (at least {TRAINED_MATCH_WINS})")
    return fields


def ablation_inspect(fresh, log: str) -> dict:
    """The reloaded ablation trainer's replay and augmentation: prioritized
    replay's priorities finite, positive and moved by the SGD steps;
    augmentation on under the standard rules."""
    fields = {"rules": fresh.engine.rules, "augment": fresh.augment,
              "prioritized": fresh.prioritized}
    if fresh.prioritized:
        prio = fresh.buffer.priority[:fresh.buffer.filled].float().cpu()
        fields.update(priorities=int(prio.numel()), priority_min=float(prio.min()),
                      priority_max=float(prio.max()),
                      priorities_distinct=int(prio.unique().numel()))
        check(bool(torch.isfinite(prio).all() and (prio > 0).all()),
              "prioritized replay: every priority finite and positive after the steps")
        check(fields["priorities_distinct"] > 1, "prioritized replay: the steps moved priorities")
    else:
        check(fresh.augment and fresh.engine.rules == "standard"
              and "augment_symmetries disabled" not in log,
              "symmetry augmentation on under the standard rules")
    return fields


def trained_phase(engine, dev) -> dict:
    """The repo's trained networks on the card (see the module docstring).
    Returns {kernel name: largest difference to its plain version on their
    weights}."""
    t0 = time.perf_counter()
    boards = random_positions(engine, GAMES, 20, np.random.default_rng(SEED), dev)
    feats, legal = engine.features(boards), engine.legal_actions(boards)
    errs = {}
    for name in trained.NAMES:
        entry = trained.manifest()["networks"][name]
        player = MCTSPlayer.from_checkpoint(trained.checkpoint(name), device=dev)
        check(next(player.model.parameters()).device.type == "cuda"
              and player.train_state["iteration"] == entry["iteration"],
              f"{name} loaded on the card at iteration {entry['iteration']}")
        t1 = time.perf_counter()
        for kname, err in check_trained_kernels(player.model, feats, f"trained_{name}").items():
            errs[kname] = max(errs.get(kname, 0.0), err)
        check_s = time.perf_counter() - t1
        rows = variants_vs_bf16(player, feats, legal, name)
        phase("trained", network=name, file=entry["file"], source=entry["source"],
              iteration=entry["iteration"], kernel_check_s=round(check_s, 3),
              variants_vs_bf16=rows)
    match = trained_match(engine, dev)
    ablations = {}
    for cfg_name in ABLATIONS:
        stem = Path(cfg_name).stem
        root = TRAINED_SCRATCH / stem
        cut = config_with(cfg_name, {**ABLATION_CUT, "paths": {
            "checkpoint_dir": str(root / "models"), "log_dir": str(root / "logs"),
            "data_dir": str(root)}})
        t1 = time.perf_counter()
        fields = cli_train_at(cut, stem, trunk_int8_dx3, dev, config=f"configs/{cfg_name}",
                              inspect=ablation_inspect)
        fields["seconds"] = round(time.perf_counter() - t1, 3)
        phase("trained", path="cli train, ablation", **fields)
        ablations[stem] = fields["seconds"]
    shutil.rmtree(TRAINED_SCRATCH, ignore_errors=True)
    phase("trained", max_abs_err=errs, match_s=match["seconds"], ablation_s=ablations,
          seconds=round(time.perf_counter() - t0, 3))
    return errs


def learn_phase() -> None:
    """A resume on the card bit for bit equal to the uninterrupted run (see
    the module docstring), through the plain forward and through
    ``int8_dx3``."""
    sys.path.insert(0, str(REPO / "tests"))
    try:
        import torch_resume
    finally:
        sys.path.remove(str(REPO / "tests"))
    t0 = time.perf_counter()
    for variant, kernel in LEARN_PATHS:
        root = LEARN_SCRATCH / variant
        shutil.rmtree(root, ignore_errors=True)

        def cut(run):
            return config_with("default_8x8.yaml", {**LEARN_CUT, "paths": {
                "checkpoint_dir": str(root / run / "models"), "log_dir": str(root / run / "logs"),
                "data_dir": str(root / run)},
                "system": {**LEARN_CUT["system"], "self_play_net_variant": variant}})

        forwards, runs, seconds = [0], {}, {}
        for k in set(VARIANT_KERNEL.values()):
            k.launches = 0
        with counted_forwards(forwards):
            for run in ("A", "B"):
                tr = trainer_lib.AlphaZeroTrainer(cut(run), log_cb=None)
                if run == "B":
                    tr.load_checkpoint(str(root / "A" / "models" / "checkpoint_iter_000001.pt"))
                    resumed_from = (tr.state.iteration, tr.buffer.total_added)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tr.train()
                torch.cuda.synchronize()
                seconds[run] = round(time.perf_counter() - t1, 3)
                tr.close()
                runs[run] = tr
        launched = {k.__name__: k.launches for k in VARIANT_KERNEL.values() if k.launches}
        a, b = runs["A"], runs["B"]
        check(a.device.type == "cuda" and a.variant == variant, f"learn {variant}: on the card")
        if kernel is None:
            check(not launched, f"learn {variant}: no trunk kernel ({launched})")
        else:
            per = launches_per_forward(kernel, 2 * a.model.num_blocks)
            check(kernel.launches > 0 and kernel.launches == per * forwards[0]
                  and set(launched) == {kernel.__name__},
                  f"learn {variant}: {kernel.__name__} launches {kernel.launches} == {per} x "
                  f"forwards {forwards[0]}, no other trunk ({launched})")
        C = a.buffer.capacity
        check(resumed_from[0] == 1 and resumed_from[1] < C < a.buffer.total_added
              and a.buffer.filled == C,
              f"learn {variant}: B resumed at iteration 1 and the ring wrapped after it "
              f"(plies {resumed_from[1]} then {a.buffer.total_added}, capacity {C})")
        check(a.state.step == 2 * a.epochs_per_iter, f"learn {variant}: 2 x 10 SGD steps")
        differ = torch_resume.differing_leaves(a, b)
        rows = {run: torch_resume.metric_log(tr.log_dir) for run, tr in runs.items()}
        compared = {run: torch_resume.compared_rows(tr.log_dir, 2) for run, tr in runs.items()}
        sgd = {run: [round(v, 3) for _, t, v in rs if t == "Time/train"]
               for run, rs in rows.items()}
        fields = {"variant": variant, "forwards": forwards[0], "trunk_launches": launched,
                  "leaves": len(torch_resume.resume_leaves(a)), "leaves_differ": differ[:10],
                  "metrics_rows": len(compared["A"]), "plies": a.buffer.total_added,
                  "capacity": C, "loss": [v for _, t, v in rows["A"] if t == "Loss/train"],
                  "sgd_s": sgd, "run_s": seconds}
        phase("learn", **fields)
        check(not differ, f"learn {variant}: resume from iteration 1 == uninterrupted run "
              f"({len(differ)} of {fields['leaves']} leaves differ: {differ[:10]})")
        check(compared["A"] == compared["B"] and compared["A"],
              f"learn {variant}: the metrics rows of iteration 2 equal")
    shutil.rmtree(LEARN_SCRATCH, ignore_errors=True)
    phase("learn", seconds=round(time.perf_counter() - t0, 3))


def shape_model(size: int, channels: int, blocks: int, init, dev) -> OthelloResNet:
    """A blocks x channels network for size x size boards, weights from a
    numpy seed through ``init``, eval mode on ``dev``."""
    m = OthelloResNet(blocks, channels, size)
    m.load_state_dict(from_jax_variables(init(blocks, channels, SEED + size + channels, size)))
    return m.to(dev).eval()


def int8_plain(variant: str):
    """The plain version of an int8 variant's kernel."""
    if variant in ("int8", "int8_bf16"):
        return trunk_int8_plain
    return trunk_int8_dx3_plain if variant == "int8_dx3" else INT8_VARIANTS[variant][1]


def check_shape_kernels(dev) -> tuple:
    """Every trunk of SHAPE_NETS at its board side and width against its
    plain version, at that entry's batches, on stem outputs of real positions: the
    int8 ones bit for bit, the forward equal to the plain trunk's; the bf16
    ones equal to their convs launched one by one, each conv within the bar
    of their 8x8 checks, the forward (trainer's initial weights) within
    probs 0.03 / value 0.05. Launches L a forward (int8_dxcat: 1). Returns
    ({kernel name: (shapes, largest difference)}, the (6, 64) networks)."""
    checked, nets = {}, {}
    for (S, C), (blocks, variants, batches) in SHAPE_NETS.items():
        eng = get_engine(S, "reference")
        feats = eng.features(random_positions(eng, max(batches), S * S // 3,
                                              np.random.default_rng(SEED + S), dev))
        layers = 2 * blocks
        models = {"he_normal": shape_model(S, C, blocks, init_numpy_variables, dev),
                  "flax_init": shape_model(S, C, blocks, init_train_variables, dev)}
        nets[S, C] = models
        for variant in variants:
            kernel = VARIANT_KERNEL[variant]
            bf16 = variant in ("matmul9", "wide")
            fused = FusedInference(models["flax_init" if bf16 else "he_normal"], variant=variant)
            before = kernel.launches
            if bf16:
                w, b = fused.trunk_w, fused.trunk_bias
                args = ((conv_matmul9, conv_plain, matmul9_bound, trunk_matmul9_plain)
                        if variant == "matmul9" else
                        (conv_wide, conv_wide_plain, conv_bound, trunk_wide_plain))
                kernel(fused.stem(feats[:1]), w, b)
                launched = kernel.launches - before
                check(launched == layers,
                      f"{variant} launched {launched} times a forward at {S}x{S}x{C}")
                err = check_bf16_convs(kernel.__name__, kernel, args[3], *args[:3], fused, feats,
                                       f"flax_init, {S}x{S}, {blocks}x{C}", batches)
                lp_k, v_k = fused(feats)
                lp_p, v_p = fused.heads(args[3](fused.stem(feats), w, b))
                dp = float((lp_k.exp() - lp_p.exp()).abs().max())
                dv = float((v_k - v_p).abs().max())
                check(dp <= 0.03 and dv <= 0.05,
                      f"FusedInference({variant}) at {S}x{S}x{C} within probs 0.03, value 0.05")
            else:
                kw = {"stage_bf16": True} if variant == "int8_bf16" else {}
                plain = int8_plain(variant)
                args = (fused.trunk_w, fused.trunk_scale, fused.trunk_bias, fused.block_games)
                err = 0.0
                for batch in batches:
                    h = fused.stem(feats[:batch])
                    before = kernel.launches
                    out_k = kernel(h, *args, **kw)
                    launched = kernel.launches - before
                    out_p = plain(h, *args, **kw)
                    torch.cuda.synchronize()
                    diff = (out_k.float() - out_p.float()).abs()
                    n_diff = int((diff != 0).sum())
                    err = max(err, float(diff.max()))
                    check(bool(torch.isfinite(out_k.float()).all()), f"finite {variant} output")
                    phase("kernel_check", kernel=kernel.__name__, variant=variant, size=S,
                          channels=C, blocks=blocks, batch=batch, differing=n_diff,
                          of=out_k.numel(), max_abs_diff=float(diff.max()), launches=launched)
                    check(n_diff == 0, f"{variant} == plain version at {S}x{S}x{C}, B={batch}")
                    check(launched == launches_per_forward(kernel, layers),
                          f"{variant} launched {launched} times a forward at {S}x{S}x{C}")
                lp_k, v_k = fused(feats)
                lp_p, v_p = fused.heads(plain(fused.stem(feats), *args, **kw))
                dp = float((lp_k.exp() - lp_p.exp()).abs().max())
                dv = float((v_k - v_p).abs().max())
                check(torch.equal(lp_k, lp_p) and torch.equal(v_k, v_p),
                      f"FusedInference({variant}) at {S}x{S}x{C} == plain trunk")
            check(lp_k.shape == (feats.shape[0], S * S + 1), f"{variant} policy shape at {S}x{S}")
            phase("kernel_check", what=f"FusedInference({variant}) kernel vs plain trunk",
                  size=S, channels=C, blocks=blocks, batch=feats.shape[0],
                  max_abs_diff_probs=dp, max_abs_diff_value=dv)
            shapes, worst = checked.get(kernel.__name__, ([], 0.0))
            if [S, C] not in shapes:
                shapes.append([S, C])
            checked[kernel.__name__] = (shapes, max(worst, err))
    return checked, nets


def metrics_rows(log_dir: Path) -> dict:
    """{tag: value} of the last row of each tag in ``log_dir/metrics.jsonl``."""
    with open(log_dir / "metrics.jsonl") as f:
        return {r["tag"]: r["value"] for r in map(json.loads, f)}


@contextlib.contextmanager
def counted_forwards(forwards: list):
    """Every network ``AlphaZeroTrainer`` makes (self-play and gate match)
    counting its forwards into ``forwards[0]``."""
    make_net = trainer_lib.AlphaZeroTrainer._net

    def counted_net(self, model):
        net = make_net(self, model)

        def f(x):
            forwards[0] += 1
            return net(x)
        return f

    trainer_lib.AlphaZeroTrainer._net = counted_net
    try:
        yield
    finally:
        trainer_lib.AlphaZeroTrainer._net = make_net


def cli_train_at(cut: dict, name: str, kernel, dev, config: str = "configs/debug_6x6.yaml",
                 inspect=None) -> dict:
    """``cli train --config`` on ``cut`` (``config`` cut, written under its
    ``paths.data_dir`` as ``name``.yaml and read back), counting the
    network's forwards and timing the gate match; then the final checkpoint
    reloaded into a fresh trainer, its network through ``kernel`` on the
    card equal to the plain trunk, and ``inspect(trainer, log)`` (its checks
    and fields) on that trainer. Checks: ``kernel`` launched
    launches_per_forward x forwards, no other trunk, no self-heal line, the
    checkpoints written. Returns the phase's fields."""
    cut = json.loads(json.dumps(cut))
    root = Path(cut["paths"]["data_dir"])
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    path = root / f"{name}.yaml"
    path.write_text(to_yaml(cut))
    check(load_config(str(path)) == cut, f"{name}: the cut copy reads back equal")
    forwards, gate = [0], []
    gate_match = trainer_lib.AlphaZeroTrainer._gate_match

    def timed_gate_match(self, seed):
        t, before = time.perf_counter(), forwards[0]
        out = gate_match(self, seed)
        torch.cuda.synchronize()
        gate.append((time.perf_counter() - t, forwards[0] - before))
        return out

    for k in set(VARIANT_KERNEL.values()):
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer_lib.AlphaZeroTrainer._gate_match = timed_gate_match
    try:
        with counted_forwards(forwards):
            _, log = captured(cli.main, ["train", "--config", str(path)])
    finally:
        trainer_lib.AlphaZeroTrainer._gate_match = gate_match
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, fwd = kernel.launches, forwards[0]
    others = {k.__name__: k.launches for k in VARIANT_KERNEL.values() if k is not kernel}
    layers = 2 * cut["model"]["num_blocks"]
    per = launches_per_forward(kernel, layers)
    check(launches > 0 and launches == per * fwd,
          f"{name}: {kernel.__name__} launches {launches} == {per} x forwards {fwd}")
    check(not any(others.values()), f"{name}: no other trunk kernel ({others})")
    check("self-heal" not in log and "iter 1/1" in log, f"{name}: one iteration, no self-heal")
    models = Path(cut["paths"]["checkpoint_dir"])
    final = models / "final_model.pt"
    check((models / "checkpoint_iter_000001.pt").is_file() and final.is_file(),
          f"{name}: checkpoint of iteration 1 and final_model written")
    rows = metrics_rows(Path(cut["paths"]["log_dir"]))
    t1 = time.perf_counter()
    fresh = trainer_lib.AlphaZeroTrainer(cut, log_cb=None)
    fresh.load_checkpoint(str(final))
    saved = torch.load(final, map_location="cpu", weights_only=True)["train_state"]
    check(fresh.state.iteration == 1 and all(
        torch.equal(saved["model"][k], v.cpu()) for k, v in fresh.model.state_dict().items()),
        f"{name}: the checkpoint reloads at iteration 1 with every tensor equal")
    S = cut["game"]["size"]
    eng = get_engine(S, "reference")
    x = eng.features(random_positions(eng, 64, S * S // 3, np.random.default_rng(SEED), dev))
    fused = FusedInference(fresh.model.eval(), variant=fresh.variant)
    lp, v = fused(x)
    args = (fused.trunk_w, fused.trunk_scale, fused.trunk_bias, fused.block_games)
    lp_p, v_p = fused.heads(int8_plain(fresh.variant)(fused.stem(x), *args))
    check(torch.equal(lp, lp_p) and torch.equal(v, v_p),
          f"{name}: the reloaded network through {kernel.__name__} == plain trunk")
    reload_s = time.perf_counter() - t1
    inspected = inspect(fresh, log) if inspect else {}
    fresh.close()
    fields = {"config": config, "size": S, **inspected,
              "model": f"{cut['model']['num_blocks']}x{cut['model']['num_filters']}",
              "variant": fresh.variant, "games": cut["training"]["self_play_episodes_per_iter"],
              "simulations": cut["mcts"]["num_simulations"],
              "sgd_steps": cut["training"]["train_epochs_per_iter"], "forwards": fwd,
              "trunk_launches": launches, "launches_per_forward": per,
              "loss": rows["Loss/train"], "self_play_s": round(rows["Time/self_play"], 3),
              "sgd_s": round(rows["Time/train"], 3), "reload_s": round(reload_s, 3),
              "train_s": round(seconds, 3)}
    if gate:
        m = re.search(r"gating @ iter 1: candidate (\d+)W-(\d+)L-(\d+)D", log)
        check(m is not None and sum(map(int, m.groups())) == cut["training"]["gating"]["games"]
              and "Gating/accepted" in rows, f"{name}: the gate match played and logged")
        fields.update(gate_games=sum(map(int, m.groups())), gate_result=m.group(0),
                      adopted=bool(rows["Gating/accepted"]), gate_match_s=round(gate[0][0], 3),
                      gate_forwards=gate[0][1])
    shutil.rmtree(root, ignore_errors=True)
    return fields


def shapes_phase(dev) -> tuple:
    """The trunks at the other shapes the JAX trunks run (see the module
    docstring): the kernel checks, the debug_6x6 iteration through int8_dx3
    and gated through int8_dxcat, the bench at 6x6, the timing at (6, 64),
    B=1024, then past 128 channels (``wide_phase``). Returns ({kernel name:
    the shapes it was checked at}, ``wide_phase``'s rows)."""
    t0 = time.perf_counter()
    checked, nets = check_shape_kernels(dev)
    check_s = time.perf_counter() - t0
    cut = config_with("debug_6x6.yaml", DEBUG_6X6_CUT)
    check((cut["game"]["size"], cut["model"]["num_blocks"], cut["model"]["num_filters"],
           cut["mcts"]["num_simulations"]) == (6, 5, 64, 10),
          "configs/debug_6x6.yaml read: 6x6, 5x64, 10 simulations")
    train_fields = cli_train_at(cut, "debug_6x6_int8_dx3", trunk_int8_dx3, dev)
    phase("shapes", path="cli train", **train_fields)
    gated = json.loads(json.dumps(cut))
    gated["training"]["gating"] = dict(DEBUG_6X6_GATE)
    gated["system"]["self_play_net_variant"] = "int8_dxcat"
    gated_fields = cli_train_at(gated, "debug_6x6_int8_dxcat_gated", trunk_int8_dxcat, dev)
    phase("shapes", path="cli train, gated", **gated_fields)

    forwards = [0]
    trunk = FusedInference.trunk

    def counted_trunk(self, h):
        forwards[0] += 1
        return trunk(self, h)

    for k in set(VARIANT_KERNEL.values()):
        k.launches = 0
    FusedInference.trunk = counted_trunk
    try:
        line = bench.run(SHAPES_BENCH)
    finally:
        FusedInference.trunk = trunk
    launches = trunk_int8_dx3.launches
    phase("shapes", argv="bench " + " ".join(SHAPES_BENCH), line=line, forwards=forwards[0],
          trunk_int8_dx3_launches=launches)
    check(launches > 0 and launches == 10 * forwards[0],
          f"bench at 6x6: int8_dx3 launches {launches} == 10 x forwards {forwards[0]}")
    check(line["model"] == "5x64" and line["net_variant"] == "int8_dx3" and line["value"] > 0,
          "bench at 6x6 through int8_dx3")

    # ms a forward at B=1024, (6, 64), 10 convs, beside the bounds: wall
    # (CUDA events; a forward of per-conv launches is the host's ctypes calls
    # at this size) and device (torch.profiler)
    eng = get_engine(6, "reference")
    feats = eng.features(random_positions(eng, GAMES, 12, np.random.default_rng(SEED), dev))
    layers = 10
    timing = {}
    for variant in SHAPE_VARIANTS:
        kernel = VARIANT_KERNEL[variant]
        bf16 = variant in ("matmul9", "wide")
        fused = FusedInference(nets[6, 64]["flax_init" if bf16 else "he_normal"], variant=variant)
        h = fused.stem(feats)
        if bf16:
            args, kw = (fused.trunk_w, fused.trunk_bias), {}
        else:
            args = (fused.trunk_w, fused.trunk_scale, fused.trunk_bias, fused.block_games)
            kw = {"stage_bf16": True} if variant == "int8_bf16" else {}
        bound_ms, bound_by = trunk_bound_ms(GAMES, layers, 64, bf16, size=6)
        names = (("bf16_conv_kernel",) if bf16 else TRUNK_DEVICE_NAMES
                 if kernel is trunk_int8_dxcat else INT8_DEVICE_NAMES)
        timing[variant] = {"kernel": kernel.__name__,
                           "ms": time_ms(lambda: kernel(h, *args, **kw), reps=20),
                           **trunk_device_ms(lambda: kernel(h, *args, **kw), names),
                           "fused_forward_ms": time_ms(lambda: fused(feats), reps=20),
                           "bound_ms": bound_ms, "bound_by": bound_by}
        if not bf16:
            timing[variant]["bytes_floor_ms"] = int8_bytes_floor_ms(GAMES, layers, 64, size=6)
    phase("shapes", timing=timing, batch=GAMES, size=6, channels=64, layers=layers)
    wide = wide_phase(dev)
    phase("shapes", kernels_checked={k: v[0] for k, v in checked.items()},
          max_abs_err={k: v[1] for k, v in checked.items()},
          kernel_check_s=round(check_s, 3), seconds=round(time.perf_counter() - t0, 3))
    return {k: v[0] for k, v in checked.items()}, wide


def wide_phase(dev) -> dict:
    """Past 128 channels, where the kernels stream a layer's weights: the
    JAX bench's wide network, ``bench --mode mcts --filters 256 --blocks 10
    --net-variant int8_dx3`` (int8_dx3 launched 20 x forwards), then each
    trunk's ms a forward at 8x8 x 256, B=1024, 20 convs (wall by CUDA
    events, device by torch.profiler) beside its bounds, the int8 ones'
    f32 bytes floor and, for the bf16 ones, the cuDNN tower;
    ``int8_dxcat`` also at its gated batches. Returns {kernel name: its
    row}."""
    forwards = [0]
    trunk = FusedInference.trunk

    def counted_trunk(self, h):
        forwards[0] += 1
        return trunk(self, h)

    for k in set(VARIANT_KERNEL.values()):
        k.launches = 0
    FusedInference.trunk = counted_trunk
    t0 = time.perf_counter()
    try:
        line = bench.run(WIDE_BENCH)
    finally:
        FusedInference.trunk = trunk
    launches = trunk_int8_dx3.launches
    phase("shapes", argv="bench " + " ".join(WIDE_BENCH), line=line, forwards=forwards[0],
          trunk_int8_dx3_launches=launches, seconds=round(time.perf_counter() - t0, 3),
          wall_s_at_25_simulations=WIDE_BENCH_WALL_S_AT_25)
    check(launches > 0 and launches == 2 * NUM_BLOCKS * forwards[0],
          f"bench at 10x256: int8_dx3 launches {launches} == 20 x forwards {forwards[0]}")
    check(line["model"] == f"{NUM_BLOCKS}x{WIDE_FILTERS}" and line["net_variant"] == "int8_dx3"
          and line["value"] > 0, "bench at 10x256 through int8_dx3")

    eng = get_engine(8, "reference")
    feats = eng.features(random_positions(eng, GAMES, 20, np.random.default_rng(SEED), dev))
    layers, C = 2 * NUM_BLOCKS, WIDE_FILTERS
    models = {init.__name__: shape_model(8, C, NUM_BLOCKS, init, dev)
              for init in (init_numpy_variables, init_train_variables)}
    bound = {bf16: trunk_bound_ms(GAMES, layers, C, bf16) for bf16 in (False, True)}
    rows = {}
    for variant in SHAPE_VARIANTS:
        kernel = VARIANT_KERNEL[variant]
        bf16 = variant in ("matmul9", "wide")
        fused = FusedInference(models["init_train_variables" if bf16 else "init_numpy_variables"],
                               variant=variant)
        h = fused.stem(feats)
        if bf16:
            args, kw = (fused.trunk_w, fused.trunk_bias), {}
        else:
            args = (fused.trunk_w, fused.trunk_scale, fused.trunk_bias, fused.block_games)
            kw = {"stage_bf16": True} if variant == "int8_bf16" else {}
        names = (BF16_DEVICE_NAMES if bf16 else TRUNK_DEVICE_NAMES
                 if kernel is trunk_int8_dxcat else INT8_DEVICE_NAMES)
        row = {"kernel": kernel.__name__, "ms": time_ms(lambda: kernel(h, *args, **kw), reps=20),
               **trunk_device_ms(lambda: kernel(h, *args, **kw), names),
               "bound_ms": bound[bf16][0], "bound_by": bound[bf16][1]}
        if bf16:
            w_oihw = [(hwio(wl) if variant == "wide" else wl)[..., :C, :C].permute(3, 2, 0, 1)
                      .contiguous(memory_format=torch.channels_last) for wl in fused.trunk_w]
            b_tower = fused.trunk_bias[:, :C].to(torch.bfloat16)
            row["cudnn_tower_ms"] = time_ms(lambda: cudnn_tower(h, w_oihw, b_tower), reps=20)
        else:
            row["bytes_floor_ms"] = int8_bytes_floor_ms(GAMES, layers, C)
        if kernel is trunk_int8_dxcat:
            row["path_batches"] = {batch: {
                "ms": time_ms(lambda: kernel(h[:batch].contiguous(), *args), reps=50),
                "bound_ms": trunk_bound_ms(batch, layers, C)[0],
                "bytes_floor_ms": int8_bytes_floor_ms(batch, layers, C)} for batch in GATE_BATCHES}
        rows[variant] = row
    phase("shapes", timing=rows, batch=GAMES, size=8, channels=C, layers=layers)
    return rows


def bench_phase() -> tuple:
    """The port's bench in process: ``--mode all --repeats 1`` (random_step
    launched once a ply), then ``--mode mcts --net-variant int8``
    (trunk_int8 launched 20 times a forward). Returns the launches of
    random_step and trunk_int8 on these runs."""
    plies, forwards = [], 0
    play_random, trunk = bench.play_random_games, FusedInference.trunk

    def counted_play(*args, **kwargs):
        out = play_random(*args, **kwargs)
        plies.append(out[2])
        return out

    def counted_trunk(self, h):
        nonlocal forwards
        forwards += 1
        return trunk(self, h)

    for kernel in (rs.random_step, trunk_int8, trunk_int8_dx3, trunk_matmul9):
        kernel.launches = 0
    bench.play_random_games = counted_play
    try:
        suite = bench.run(["--mode", "all", "--repeats", "1"])
    finally:
        bench.play_random_games = play_random
    step_launches = rs.random_step.launches
    phase("bench", argv="--mode all --repeats 1", line=suite)
    check(step_launches > 0 and step_launches == sum(plies),
          f"random_step launches {step_launches} == plies {sum(plies)}")
    check(trunk_int8_dx3.launches > 0, "the bench's mcts mode ran int8_dx3")
    check(suite["modes"]["mcts"]["net_variant"] == "int8_dx3", "mcts picks int8_dx3 on the card")
    trunk_int8.launches = 0
    FusedInference.trunk = counted_trunk
    try:
        line = bench.run(["--mode", "mcts", "--net-variant", "int8", "--repeats", "1"])
    finally:
        FusedInference.trunk = trunk
    int8_launches = trunk_int8.launches
    phase("bench", argv="--mode mcts --net-variant int8 --repeats 1", line=line,
          forwards=forwards, trunk_int8_launches=int8_launches)
    check(int8_launches > 0 and int8_launches == 2 * NUM_BLOCKS * forwards,
          f"trunk_int8 launches {int8_launches} == 20 x forwards {forwards}")
    return step_launches, int8_launches


def benchmark_model_phase() -> dict:
    """The port's benchmark_model in process: ``--fused --fused-variants``
    every ported variant, default batches, ``--chain 16 --repeats 2``. Each
    variant's boards/s table is printed; every row at B >= 256 must be a
    number; each kernel's launches must be launches_per_forward x the
    forwards of the variants that run it. Returns the launches of each
    kernel."""
    forwards = {}
    trunk = FusedInference.trunk

    def counted_trunk(self, h):
        forwards[self.variant] = forwards.get(self.variant, 0) + 1
        return trunk(self, h)

    kernels = set(VARIANT_KERNEL.values())
    for kernel in kernels:
        kernel.launches = 0
    argv = ["--fused", "--fused-variants", *BENCH_VARIANTS, "--chain", "16", "--repeats", "2"]
    FusedInference.trunk = counted_trunk
    try:
        out = benchmark_model.run(argv)
    finally:
        FusedInference.trunk = trunk
    tables = {}
    for row in out["rows"]:
        tables.setdefault(row["table"], {})[row["batch"]] = (
            round(row["boards_per_s"], 1) if row["status"] == "ok" else row["status"])
    phase("benchmark_model", argv=" ".join(argv), dispatch_ms=out["dispatch_ms"],
          params=out["params"], memory_mib=out["memory_mib"], forwards=forwards,
          boards_per_s=tables)
    bad = [(t, b, v) for t, row in tables.items() for b, v in row.items()
           if b >= 256 and not isinstance(v, float)]
    check(not bad, f"every benchmark_model row at B >= 256 is a number ({bad})")
    check(set(tables) == {"bf16", "f32", *BENCH_VARIANTS}, "a table for every variant")
    launches = {}
    for kernel in kernels:
        want = launches_per_forward(kernel) * sum(n for v, n in forwards.items()
                                                  if VARIANT_KERNEL.get(v) is kernel)
        check(want > 0 and kernel.launches == want,
              f"{kernel.__name__} launches {kernel.launches} == {launches_per_forward(kernel)}"
              f" x its forwards ({want})")
        launches[kernel.__name__] = kernel.launches
    return launches


def profiler_launches_ok(out: dict, row: dict) -> bool:
    """A profiler row's trunk launches: launches_per_forward x its forwards
    of the kernel of its variant (a trunk row's, a full forward's, else the
    profiler's network), none without a forward or through the plain
    forward."""
    variant = row.get("variant") or (f"int8_{row['kernel']}" if "kernel" in row
                                     else out.get("net_variant"))
    kernel = VARIANT_KERNEL.get(variant)
    want = ({kernel.__name__: launches_per_forward(kernel) * row["forwards"]}
            if kernel and row["forwards"] else {})
    return row["kernel_launches"] == want


def profilers_phase() -> dict:
    """The four profilers on the card through their ``main(argv)``
    (PROFILER_RUNS), each JSON line printed. Checks: the device is CUDA;
    every row present with every figure finite; a complete profiled pass
    (every marker recorded); device-busy ms within the profiled wall ms;
    each row's trunk launches (:func:`profiler_launches_ok`); the five
    parts' device operations summing exactly to one whole simulation's at
    the same state. Returns {profiler name and batch: its JSON object}."""
    t0 = time.perf_counter()
    outs = {}
    for module, argv, names in PROFILER_RUNS:
        t1 = time.perf_counter()
        _, text = captured(module.main, argv)
        out = json.loads(text.strip().splitlines()[-1])
        key = f"{out['profiler']} B={out['batch']}"
        outs[key] = out
        phase("profilers", argv=" ".join(argv), seconds=round(time.perf_counter() - t1, 3),
              **out)
        check(out["device"].startswith("cuda"), f"{key} ran on the card")
        rows = {r["name"]: r for r in out["rows"]}
        check(list(rows) == ["null (per-call overhead)"] + names, f"{key}: rows {list(rows)}")
        for name, row in rows.items():
            figures = [row["wall_ms"]["best"], row["wall_ms"]["median"], *row["wall_ms"]["range"],
                       row["event_ms"]["best"], row["profiled_wall_ms"], row["syncs"],
                       row["device_busy_ms"], row["launches"]]
            check(all(isinstance(v, (int, float)) and np.isfinite(v) for v in figures),
                  f"{key} {name}: every figure finite ({figures})")
            check(row["profile_complete"], f"{key} {name}: a profiled pass recorded every "
                                           f"marker ({row['passes']})")
            check(row["device_busy_ms"] <= row["profiled_wall_ms"],
                  f"{key} {name}: device busy {row['device_busy_ms']} <= profiled wall "
                  f"{row['profiled_wall_ms']} ms")
            check(profiler_launches_ok(out, row),
                  f"{key} {name}: trunk launches {row['kernel_launches']} for "
                  f"{row['forwards']} forwards")
        if out["profiler"] == "profile_mcts_parts":
            parts = sum(rows[p]["launches"] for p in PROFILE_PARTS)
            whole = rows["whole simulation"]["launches"]
            check(parts == whole, f"{key}: the parts' launches {parts} == one whole "
                                  f"simulation's {whole}")
    # the profiled sessions each row took (2 when no pass lost a marker)
    phase("profilers", seconds=round(time.perf_counter() - t0, 3),
          tries={key: {r["name"]: r["tries"] for r in out["rows"]} for key, out in outs.items()})
    return outs


def cudnn_tower(h: torch.Tensor, w: list, b: torch.Tensor) -> torch.Tensor:
    """The folded matmul9 tower as 20 bf16 cuDNN convolutions with ReLU and
    the residual add: the library yardstick. h: (B, S, S, C), whose NCHW
    view is channels last; w: per layer OIHW weights, channels last."""
    x = h.permute(0, 3, 1, 2)
    for i in range(0, len(w), 2):
        y = torch.relu(torch.nn.functional.conv2d(x, w[i], b[i], padding=1))
        x = torch.relu(x + torch.nn.functional.conv2d(y, w[i + 1], b[i + 1], padding=1))
    return x


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

    t0 = time.perf_counter()
    # every source at 8x8/128 (random_step at none) and the trunks at phase
    # shapes' shapes: one nvcc a library, all started together
    jobs = [(name, None if name in build.UNSHAPED else (8, NUM_FILTERS))
            for name in build.SOURCES] + SHAPE_BUILDS
    with ThreadPoolExecutor(len(jobs)) as pool:
        built_all = dict(zip(jobs, pool.map(lambda job: build.build(*job), jobs)))
    for (kname, shape), built in built_all.items():
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln]
        phase("build", kernel=kname, shape=shape, seconds=round(built.seconds, 2),
              library=built.path.name, ptxas=ptxas)
    phase("build", wall_seconds=round(time.perf_counter() - t0, 2), libraries=len(jobs),
          shape_libraries_seconds=round(sum(built_all[job].seconds for job in SHAPE_BUILDS), 2))
    builds = {kname: built for (kname, shape), built in built_all.items()
              if shape in (None, (8, NUM_FILTERS))}
    wgmma_evidence(builds)

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
    max_abs_err, (lp_k, v_k) = check_int8_dx3(fused, feats)
    check(lp_k.shape == (GAMES, 65) and v_k.shape == (GAMES, 1), "output shapes")
    check(bool(torch.allclose(lp_k.exp().sum(-1), torch.ones(GAMES, device=dev), atol=1e-4)),
          "policy sums to 1")
    # matmul9 on the same He-normal weights, whose 20-conv tower amplifies
    # summation-order differences into whole moves of the policy, then on
    # the trainer's initial weights, the network the train phase plays with
    m9_max_abs_err = check_matmul9(FusedInference(model, variant="matmul9"), feats,
                                   "he_normal", check_forward=False)
    model_t = OthelloResNet(NUM_BLOCKS, NUM_FILTERS)
    model_t.load_state_dict(from_jax_variables(init_train_variables(NUM_BLOCKS, NUM_FILTERS, SEED)))
    fused_m9 = FusedInference(model_t.to(dev), variant="matmul9")
    m9_max_abs_err = max(m9_max_abs_err, check_matmul9(fused_m9, feats, "flax_init",
                                                       check_forward=True))
    int8_max_abs_err, fused8 = check_trunk_int8(model, feats)
    # wide on both weight sets too; its forward bar only on the trainer's
    wide_max_abs_err = max(
        check_wide(FusedInference(model, variant="wide"), feats, "he_normal", False),
        check_wide(FusedInference(model_t, variant="wide"), feats, "flax_init", True))
    variants = check_int8_variants(model, feats)
    step_max_abs_err = check_random_step(dev)

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
    search_check(engine, feats, dev)
    arena_check(engine, dev)

    # main path: self-play through the kernel
    forwards = 0

    def net(x):
        nonlocal forwards
        forwards += 1
        return fused(x)

    torch.cuda.synchronize()
    trunk_int8_dx3.launches = 0
    trunk_matmul9.launches = 0
    t0 = time.perf_counter()
    traj = play_games(engine, net, GAMES, SIMS, c_puct=1.0, temperature_threshold=15,
                      add_noise=True, seed=SEED, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = trunk_int8_dx3.launches
    mask = traj.mask
    plies = int(mask.any(dim=0).sum())
    check(launches > 0, "self-play launched the trunk kernel")
    check(trunk_matmul9.launches == 0, "no matmul9 trunk in the int8_dx3 self-play")
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

    # the training path: one f32 step card vs CPU, then one flagship iteration
    train_step_check(engine, feats.cpu(), rng)
    m9_launches = train_iteration(dev)
    dxcat_launches = gating_phase()
    cli_phase(engine, dev)
    distributed_phase(engine, dev)
    frontends_phase(engine, dev)
    trained_errs = trained_phase(engine, dev)
    learn_phase()
    step_launches, int8_launches = bench_phase()
    variant_launches = benchmark_model_phase()
    shapes_checked, wide_rows = shapes_phase(dev)
    profilers_phase()

    # timing at the main paths' shape (B=1024)
    h = fused.stem(feats)
    kernel_ms = time_ms(lambda: trunk_int8_dx3(h, w, ws, b), reps=20)
    dx3_device = trunk_device_ms(lambda: trunk_int8_dx3(h, w, ws, b), INT8_DEVICE_NAMES)
    int8_floor_ms = int8_bytes_floor_ms(GAMES, layers, NUM_FILTERS)
    plain_ms = time_ms(lambda: trunk_int8_dx3_plain(h, w, ws, b), reps=3, warmup=1)
    forward_ms = time_ms(lambda: fused(feats), reps=20)
    bound_ms, bound_by = trunk_bound_ms(GAMES, layers, NUM_FILTERS)
    h9, w9, b9 = fused_m9.stem(feats), fused_m9.trunk_w, fused_m9.trunk_bias
    w_oihw = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) for w in w9]
    b_bf16 = b9.to(torch.bfloat16)
    m9_ms = time_ms(lambda: trunk_matmul9(h9, w9, b9), reps=20)
    m9_device = trunk_device_ms(lambda: trunk_matmul9(h9, w9, b9))
    m9_plain_ms = time_ms(lambda: trunk_matmul9_plain(h9, w9, b9), reps=3, warmup=1)
    m9_forward_ms = time_ms(lambda: fused_m9(feats), reps=20)
    cudnn_ms = time_ms(lambda: cudnn_tower(h9, w_oihw, b_bf16), reps=20)
    m9_bound_ms, m9_bound_by = trunk_bound_ms(GAMES, layers, NUM_FILTERS, bf16=True)
    h8, w8, ws8, b8 = fused8.stem(feats), fused8.trunk_w, fused8.trunk_scale, fused8.trunk_bias
    int8_ms = time_ms(lambda: trunk_int8(h8, w8, ws8, b8), reps=20)
    int8_bf16_ms = time_ms(lambda: trunk_int8(h8, w8, ws8, b8, stage_bf16=True), reps=20)
    int8_device = trunk_device_ms(lambda: trunk_int8(h8, w8, ws8, b8), INT8_DEVICE_NAMES)
    int8_bf16_device = trunk_device_ms(lambda: trunk_int8(h8, w8, ws8, b8, stage_bf16=True),
                                       INT8_DEVICE_NAMES)
    int8_plain_ms = time_ms(lambda: trunk_int8_plain(h8, w8, ws8, b8), reps=3, warmup=1)
    int8_bf16_plain_ms = time_ms(lambda: trunk_int8_plain(h8, w8, ws8, b8, stage_bf16=True),
                                 reps=3, warmup=1)
    int8_forward_ms = time_ms(lambda: fused8(feats), reps=20)
    start = engine.initial_state((RANDOM_GAMES,), device=dev)
    big = fused_step.pack_boards(start.me, start.opp)
    big_words = rs.draw_words(big.shape[1:], torch.Generator(device=dev).manual_seed(SEED))
    step_ms = time_ms(lambda: rs.random_step(big, big_words), reps=20)
    step_plain_ms = time_ms(lambda: rs.random_step_plain(big, big_words), reps=3, warmup=1)
    (new_k, live_k), (new_p, live_p) = (rs.random_step(big, big_words),
                                        rs.random_step_plain(big, big_words))
    d = u32_diff(new_k, new_p)
    step_max_abs_err = max(step_max_abs_err, float(d.max()),
                           float((live_k - live_p).abs().max()))
    check(int((d != 0).sum()) == 0 and torch.equal(live_k, live_p),
          "timed random_step == plain version")
    step_t_bytes = RANDOM_GAMES * RANDOM_STEP_BYTES / BYTES_PER_S * 1e3
    step_t_ops = RANDOM_GAMES * RANDOM_STEP_OPS / INT32_OPS_PER_S * 1e3
    step_bound_ms, step_bound_by = ((step_t_ops, "operations") if step_t_ops >= step_t_bytes
                                    else (step_t_bytes, "bytes"))
    del big, big_words, new_k, live_k, new_p, live_p, d
    fused_w = FusedInference(model_t, variant="wide")
    hw, ww, bw = fused_w.stem(feats), fused_w.trunk_w, fused_w.trunk_bias
    wide_ms = time_ms(lambda: trunk_wide(hw, ww, bw), reps=20)
    wide_device = trunk_device_ms(lambda: trunk_wide(hw, ww, bw))
    wide_plain_ms = time_ms(lambda: trunk_wide_plain(hw, ww, bw), reps=3, warmup=1)
    wide_forward_ms = time_ms(lambda: fused_w(feats), reps=20)
    w_wide = [hwio(wl).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
              for wl in ww]
    wide_cudnn_ms = time_ms(lambda: cudnn_tower(hw, w_wide, bw.to(torch.bfloat16)), reps=20)
    variant_ms = {}
    for variant, (kernel, plain, _) in INT8_VARIANTS.items():
        fv = variants[variant][1]
        hv, args = fv.stem(feats), (fv.trunk_w, fv.trunk_scale, fv.trunk_bias, fv.block_games)
        variant_ms[variant] = (time_ms(lambda: kernel(hv, *args), reps=20),
                               time_ms(lambda: plain(hv, *args), reps=3, warmup=1),
                               time_ms(lambda: fv(feats), reps=20))
        check(torch.equal(kernel(hv, *args), plain(hv, *args)), f"timed {variant} == plain")
    # int8_dxcat's main path, the gated iteration, runs at its self-play and
    # gate-match batches; the int8 conv body as int8_dx3 launches it at the
    # first of them; the device time of int8_m9, int8_patch and int8_flat at B=1024
    check(STRONG["self_play"]["num_parallel_games"] == GATE_BATCHES[0]
          and STRONG["training"]["gating"]["games"] == GATE_BATCHES[1], "the gated batches")
    fx = variants["int8_dxcat"][1]
    fx_args = (fx.trunk_w, fx.trunk_scale, fx.trunk_bias, fx.block_games)
    dxcat_path = {}
    for batch in GATE_BATCHES + (GAMES,):
        hx = fx.stem(feats[:batch])
        dxcat_path[batch] = {
            "kernel_ms": time_ms(lambda: trunk_int8_dxcat(hx, *fx_args), reps=50),
            **trunk_device_ms(lambda: trunk_int8_dxcat(hx, *fx_args), TRUNK_DEVICE_NAMES),
            "bound_ms": trunk_bound_ms(batch, layers, NUM_FILTERS)[0],
            "bytes_floor_ms": int8_bytes_floor_ms(batch, layers, NUM_FILTERS)}
    h_small = fused.stem(feats[:GATE_BATCHES[0]])
    dx3_small = {"batch": GATE_BATCHES[0],
                 "kernel_ms": time_ms(lambda: trunk_int8_dx3(h_small, w, ws, b), reps=50),
                 **trunk_device_ms(lambda: trunk_int8_dx3(h_small, w, ws, b), INT8_DEVICE_NAMES),
                 "bound_ms": trunk_bound_ms(GATE_BATCHES[0], layers, NUM_FILTERS)[0],
                 "bytes_floor_ms": int8_bytes_floor_ms(GATE_BATCHES[0], layers, NUM_FILTERS)}
    body_device = {}
    for variant in BODY_BG32:
        fv = variants[variant][1]
        hv, args = fv.stem(feats), (fv.trunk_w, fv.trunk_scale, fv.trunk_bias, fv.block_games)
        body_device[variant] = trunk_device_ms(lambda: INT8_VARIANTS[variant][0](hv, *args),
                                               INT8_DEVICE_NAMES)
    boards = random_positions(engine, GAMES, 20, rng, dev)
    phase("profile", what=f"one search at B={GAMES}, {SIMS} simulations, 20 plies in",
          **profile_search(engine, fused, boards))
    phase("timing", kernel="trunk_int8_dx3", batch=GAMES, kernel_ms=kernel_ms, **dx3_device,
          plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
          bytes_floor_ms=int8_floor_ms, fused_forward_ms=forward_ms,
          launches_per_forward=layers, launches_per_ply=launches / plies,
          forward_share_of_selfplay=forward_ms * forwards / 1e3 / seconds,
          small_batch=dx3_small)
    phase("timing", kernel="trunk_matmul9", batch=GAMES, kernel_ms=m9_ms, **m9_device,
          plain_ms=m9_plain_ms, bound_ms=m9_bound_ms, bound_by=m9_bound_by,
          fused_forward_ms=m9_forward_ms, launches_per_forward=layers,
          library_ms=cudnn_ms, library="cuDNN tower: 20 bf16 F.conv2d calls (channels last) "
          "with ReLU and the residual add, not one call")
    phase("timing", kernel="trunk_int8", batch=GAMES, kernel_ms=int8_ms, **int8_device,
          kernel_bf16_ms=int8_bf16_ms, device_bf16_ms=int8_bf16_device.get("device_ms"),
          plain_ms=int8_plain_ms, plain_bf16_ms=int8_bf16_plain_ms, bound_ms=bound_ms,
          bound_by=bound_by, bytes_floor_ms=int8_floor_ms,
          fused_forward_ms=int8_forward_ms, launches_per_forward=layers, library_ms=None)
    phase("timing", kernel="trunk_wide", batch=GAMES, kernel_ms=wide_ms, **wide_device,
          plain_ms=wide_plain_ms, bound_ms=m9_bound_ms, bound_by=m9_bound_by,
          fused_forward_ms=wide_forward_ms, launches_per_forward=layers,
          library_ms=wide_cudnn_ms, library="the same cuDNN tower as trunk_matmul9's, on "
          "the wide trunk's weights")
    for variant, (k_ms, p_ms, f_ms) in variant_ms.items():
        at_path = ({"path_batches": dxcat_path} if variant == "int8_dxcat"
                   else {**body_device[variant], "bytes_floor_ms": int8_floor_ms})
        phase("timing", kernel=INT8_VARIANTS[variant][0].__name__, batch=GAMES,
              block_games=block_size(GAMES, variants[variant][1].block_games), kernel_ms=k_ms,
              plain_ms=p_ms,
              bound_ms=bound_ms, bound_by=bound_by, fused_forward_ms=f_ms,
              launches_per_forward=launches_per_forward(INT8_VARIANTS[variant][0]),
              library_ms=None, **at_path)
    phase("timing", kernel="random_step", games=RANDOM_GAMES, kernel_ms=step_ms,
          plain_ms=step_plain_ms, bound_ms=step_bound_ms, bound_by=step_bound_by,
          bytes_ms=step_t_bytes, operations_ms=step_t_ops, ops_per_game=RANDOM_STEP_OPS,
          bytes_per_game=RANDOM_STEP_BYTES, library_ms=None)

    kernels = [{
        "name": "trunk_int8_dx3", "route": "cuda", "source": TRUNK_SOURCE,
        "replaces": TRUNK_REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }, {
        "name": "trunk_matmul9", "route": "cuda", "source": M9_SOURCE,
        "replaces": M9_REPLACES, "launches": m9_launches,
        "max_abs_err": m9_max_abs_err, "ms": m9_ms, "plain_ms": m9_plain_ms,
        "bound_ms": m9_bound_ms, "bound_by": m9_bound_by, "library_ms": cudnn_ms,
    }, {
        "name": "trunk_int8", "route": "cuda", "source": INT8_SOURCE,
        "replaces": INT8_REPLACES, "launches": int8_launches,
        "max_abs_err": int8_max_abs_err, "ms": int8_ms, "plain_ms": int8_plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }, {
        "name": "random_step", "route": "cuda", "source": STEP_SOURCE,
        "replaces": STEP_REPLACES, "launches": step_launches,
        "max_abs_err": step_max_abs_err, "ms": step_ms, "plain_ms": step_plain_ms,
        "bound_ms": step_bound_ms, "bound_by": step_bound_by, "library_ms": None,
    }, {
        "name": "trunk_wide", "route": "cuda", "source": f"{CSRC}/trunk_wide.cu",
        "replaces": f"{PALLAS}:127", "launches": variant_launches["trunk_wide"],
        "max_abs_err": wide_max_abs_err, "ms": wide_ms, "plain_ms": wide_plain_ms,
        "bound_ms": m9_bound_ms, "bound_by": m9_bound_by, "library_ms": wide_cudnn_ms,
    }]
    # each kernel's launches on its main path: benchmark_model's, and for
    # int8_dxcat the gated training iteration's
    variant_launches["trunk_int8_dxcat"] = dxcat_launches
    for variant, (kernel, _, line) in INT8_VARIANTS.items():
        k_ms, p_ms, _ = variant_ms[variant]
        kernels.append({
            "name": kernel.__name__, "route": "cuda", "source": f"{CSRC}/{kernel.__name__}.cu",
            "replaces": f"{PALLAS}:{line}", "launches": variant_launches[kernel.__name__],
            "max_abs_err": variants[variant][0], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    # the shapes each kernel was checked at on the card in this run
    # (random_step: the board sides), and each trunk's time past 128
    # channels (8x8 x 256, B=1024) beside that shape's bound
    for k in kernels:
        if k["name"] in trained_errs:
            k["max_abs_err_trained"] = trained_errs[k["name"]]
        k["shapes"] = ([[8, NUM_FILTERS]] + shapes_checked.get(k["name"], [])
                       if k["name"] != "random_step" else [[8], [6], [4]])
    for variant, row in wide_rows.items():
        k = next(k for k in kernels if k["name"] == row["kernel"])
        key = "ms_8x8x256" if variant != "int8_bf16" else "ms_8x8x256_stage_bf16"
        k[key], k["bound_ms_8x8x256"] = row["ms"], row["bound_ms"]
    phase("done", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-rank"]:
        sys.exit(distributed_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
