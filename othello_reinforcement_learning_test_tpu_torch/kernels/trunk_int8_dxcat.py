"""The ``int8_dxcat`` residual trunk: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel ``_trunk_kernel_int8_dxcat``
(``othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:377``),
reached through ``fused_trunk_int8(kernel="dxcat")``. The kernel is
``csrc/trunk_int8_dxcat.cu``; its note states the bound and the design: the
three dx-shifted int8 copies lane-concatenated into one (M, 3C) tile, one
K = 3C product per dy, and the dy shift on the int32 output.

It computes the ``int8_dx3`` function (per-block activation scale,
per-output-channel weight scale; integer sums are exact in any order), so
its plain version is the plain ``int8_dx3`` trunk on the same weights in
tap-major rows, and the two agree bit for bit. :func:`trunk_int8_dxcat`
launches the kernel for a CUDA tensor and uses :func:`trunk_int8_dxcat_plain`
only for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from .trunk_int8_dx3 import (block_size, check_int8_args, int8_library, int8_trunk,
                             launch_int8_trunk)
from .trunk_matmul9 import OFFSETS

DEFAULT_BLOCK_GAMES = 64  # the JAX package's FusedInference default for int8_dxcat


def trunk_int8_dxcat_plain(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                           bias: torch.Tensor,
                           block_games: int = DEFAULT_BLOCK_GAMES) -> torch.Tensor:
    """Plain PyTorch version of the kernel: bf16 (B, S, S, C) in, bf16 out,
    any S and C; w: (L, 3, 3C, C) int8, whose rows (dy, dx, C_in) are the
    taps in ``OFFSETS`` order."""
    L, _, K3, C = w.shape
    bg = block_size(x.shape[0], block_games)
    return int8_trunk(x.to(torch.float32), w.reshape(L, 3 * K3, C), OFFSETS, w_scale, bias,
                      bg).to(torch.bfloat16)


def trunk_int8_dxcat(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor,
                     block_games: int = DEFAULT_BLOCK_GAMES) -> torch.Tensor:
    """Int8 residual trunk. x: (B, S, S, C) bf16; w: (L, 3, 3C, C) int8,
    dy-major groups with (dx block, C_in)-major rows; w_scale, bias: (L, C)
    f32. Returns bf16 (B, S, S, C).

    On a CUDA tensor this launches the hand-written kernel (one launch per
    conv, each counted in ``trunk_int8_dxcat.launches``; 8x8 boards and 128
    channels only) or raises; the plain version runs only for a tensor on
    the CPU.
    """
    check_int8_args(x, w, w_scale, bias, lambda C: (3, 3 * C, C))
    if x.device.type == "cpu":
        return trunk_int8_dxcat_plain(x, w, w_scale, bias, block_games)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = int8_library("trunk_int8_dxcat", "trunk_dxcat")
    return launch_int8_trunk(trunk_int8_dxcat, lib.trunk_dxcat_prepass, lib.trunk_dxcat_conv,
                             x, w, w_scale, bias, block_games)


trunk_int8_dxcat.launches = 0
