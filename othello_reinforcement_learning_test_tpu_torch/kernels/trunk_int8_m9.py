"""The ``int8_m9`` residual trunk: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel ``_trunk_kernel_int8_m9``
(``othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:192``),
reached through ``fused_trunk_int8(kernel="m9")``. The kernel is
``csrc/trunk_int8_m9.cu``; its note states the bound and the design: a
zero-padded int8 tile and nine (M, C) @ (C, C) products summed in int32.

It computes the ``int8_dx3`` function (per-block activation scale,
per-output-channel weight scale; integer sums are exact in any order), so
its plain version is the plain ``int8_dx3`` trunk on the same weights in
tap-major rows, and the two agree bit for bit. :func:`trunk_int8_m9`
launches the kernel for a CUDA tensor and uses :func:`trunk_int8_m9_plain`
only for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from .trunk_int8_dx3 import (block_size, check_int8_args, int8_library, int8_trunk,
                             launch_int8_trunk)
from .trunk_matmul9 import OFFSETS

DEFAULT_BLOCK_GAMES = 32  # the JAX package's FusedInference default for int8_m9


def trunk_int8_m9_plain(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                        bias: torch.Tensor,
                        block_games: int = DEFAULT_BLOCK_GAMES) -> torch.Tensor:
    """Plain PyTorch version of the kernel: bf16 (B, S, S, C) in, bf16 out,
    any S and C; w: (L, 9, C, C) int8."""
    L, _, C, _ = w.shape
    bg = block_size(x.shape[0], block_games)
    return int8_trunk(x.to(torch.float32), w.reshape(L, 9 * C, C), OFFSETS, w_scale, bias,
                      bg).to(torch.bfloat16)


def trunk_int8_m9(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                  bias: torch.Tensor, block_games: int = DEFAULT_BLOCK_GAMES) -> torch.Tensor:
    """Int8 residual trunk. x: (B, S, S, C) bf16; w: (L, 9, C, C) int8, one
    (C_in, C_out) matrix per tap in ``OFFSETS`` order; w_scale, bias: (L, C)
    f32. Returns bf16 (B, S, S, C).

    On a CUDA tensor this launches the hand-written kernel (one launch per
    conv, each counted in ``trunk_int8_m9.launches``; 8x8 boards and 128
    channels only) or raises; the plain version runs only for a tensor on
    the CPU.
    """
    check_int8_args(x, w, w_scale, bias, lambda C: (9, C, C))
    if x.device.type == "cpu":
        return trunk_int8_m9_plain(x, w, w_scale, bias, block_games)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = int8_library("trunk_int8_m9", "trunk_int8m9")
    return launch_int8_trunk(trunk_int8_m9, lib.trunk_int8m9_prepass, lib.trunk_int8m9_conv,
                             x, w, w_scale, bias, block_games)


trunk_int8_m9.launches = 0
