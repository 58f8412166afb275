"""The bf16 ``wide`` residual trunk: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel ``_trunk_kernel_wide``
(``othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:127``,
with ``_shifted_accum`` ``:112``), reached through ``fused_trunk_wide``
(variant ``"wide"``). The kernel is ``csrc/trunk_wide.cu``; its note states
the bound and the design.

Each conv takes one (M, C) @ (C, 9C) product of the unshifted input with
all nine taps' columns, f32-accumulated and **rounded to bf16**, then adds
tap k's columns at the output position shifted by ``OFFSETS[k]``: in f32,
from the bias, in ``OFFSETS`` order. That rounding is what sets it apart
from ``matmul9``, whose taps are never rounded. The CUDA kernel shifts the
input instead, as ``matmul9``'s does: rounding is elementwise and the shift
only moves rows, so ``bias + sum_k bf16(shift_k(h) @ w_k)`` is the same
function (``tests/test_torch_trunk_variants.py`` holds the identity).

:func:`trunk_wide` launches the kernel for a CUDA tensor and uses
:func:`trunk_wide_plain` only for a tensor on the CPU. The nine f32 adds are
the same in both; the f32 dot behind each tap's product is not: the tensor
cores sum its 128 products in their own order, and an ulp of f32 there can
move the rounded bf16 product by one bf16 ulp. So the kernel is held conv by
conv within PyTorch's bf16 default plus :func:`tap_ulp_bound` plus
``sum_error_bound``, and the whole trunk bit for bit to its convs launched
one by one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import build
from .trunk_matmul9 import (OFFSETS, at_width, bf16_conv_function, bf16_forward, check_bf16_args,
                            launch_bf16_one_conv, launch_bf16_trunk, run_at_width,
                            sum_error_bound)


def wide_taps(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The nine taps' products of one conv, rounded to bf16: h (B, S, S, C)
    bf16, w (C, 9C) bf16 -> (B, S, S, 9C) bf16 (f32 accumulation).

    On the CPU this is PyTorch's bf16 product, which accumulates in f32 and
    rounds once, and sums in the order of XLA's CPU dot, so the plain trunk
    follows the interpreted Pallas kernel; on CUDA, where cuBLAS may reduce a
    bf16 product in lower precision, the product is taken in f32 and
    rounded."""
    B, S, _, C = h.shape
    if h.device.type == "cpu":
        z = h.reshape(-1, C) @ w
    else:
        z = (h.reshape(-1, C).to(torch.float32) @ w.to(torch.float32)).to(torch.bfloat16)
    return z.reshape(B, S, S, 9 * C)


def shifted_sum(z: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``bias + sum_k z[p + OFFSETS[k], tap k]`` in f32, in ``OFFSETS``
    order, zero outside the board: z (B, S, S, 9C) -> (B, S, S, C) f32."""
    B, S, _, C9 = z.shape
    C = C9 // 9
    zp = F.pad(z.to(torch.float32), (0, 0, 1, 1, 1, 1))
    acc = bias.expand(B, S, S, C)
    for k, (dy, dx) in enumerate(OFFSETS):
        acc = acc + zp[:, 1 + dy:1 + dy + S, 1 + dx:1 + dx + S, k * C:(k + 1) * C]
    return acc


def conv_wide_plain(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv with its epilogue, bf16 out: ``relu(acc)`` for the first
    conv of a block, ``relu(f32(resid) + acc)`` for the second. w and bias
    may be at the kernels' width (h and resid are padded to it)."""
    def conv(hw, rw):
        z = shifted_sum(wide_taps(hw, w), bias)
        if rw is not None:
            z = rw.to(torch.float32) + z
        return torch.relu(z).to(torch.bfloat16)
    return run_at_width(h, bias.shape[-1], conv, resid)


def trunk_wide_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: bf16 (B, S, S, C) in, bf16 out,
    any S and C. w: (L, C, 9C) bf16; bias: (L, C) f32; or both at the
    kernels' width."""
    def trunk(h):
        for i in range(w.shape[0] // 2):
            y = conv_wide_plain(h, w[2 * i], bias[2 * i])
            h = conv_wide_plain(y, w[2 * i + 1], bias[2 * i + 1], resid=h)
        return h
    return run_at_width(x, bias.shape[-1], trunk)


def hwio(w: torch.Tensor) -> torch.Tensor:
    """One layer's (C, 9C) wide weights -> (3, 3, C, C) HWIO."""
    C = w.shape[0]
    return w.reshape(C, 9, C).permute(1, 0, 2).reshape(3, 3, C, C)


def tap_ulp_bound(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each tap's product, summed at the output position it
    is added to: how far the kernel's sum may move when each of its nine
    rounded products lies one bf16 ulp from the plain version's. (B, S, S,
    C) f32; w at C or at the kernels' width."""
    def bound(hw):
        z = wide_taps(hw, w).to(torch.float32).abs()
        _, exp = torch.frexp(z)  # z = m * 2^exp, 0.5 <= m < 1
        ulp = torch.where(z > 0, torch.ldexp(torch.ones_like(z), exp - 8), torch.zeros_like(z))
        return shifted_sum(ulp, torch.zeros(w.shape[0], dtype=torch.float32, device=hw.device))
    return run_at_width(h, w.shape[0], bound)


def conv_bound(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               want: torch.Tensor) -> torch.Tensor:
    """The per-conv bar between kernel and plain version (see the module
    docstring): PyTorch's bf16 default (rtol 1.6e-2, atol 1e-5) on the plain
    output ``want``, plus :func:`tap_ulp_bound`, plus the f32 summation bound
    of ``sum_error_bound`` for the dots behind the products."""
    return (1e-5 + 1.6e-2 * want.to(torch.float32).abs() + tap_ulp_bound(h, w)
            + sum_error_bound(h, hwio(w), bias))


def _wide(C: int) -> tuple:
    return (C, 9 * C)


def wide_at_width(w: torch.Tensor, width: int) -> torch.Tensor:
    """(..., C, 9C) wide weights with zero channels in and out (in each
    tap's column block) up to ``width``."""
    C = w.shape[-2]
    if width == C:
        return w
    w4 = w.reshape(*w.shape[:-2], C, 9, C)
    return at_width(w4, (w4.dim() - 3, w4.dim() - 1), width).reshape(
        *w.shape[:-2], width, 9 * width)


def trunk_wide(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """bf16 residual trunk. x: (B, S, S, C) bf16; w: (L, C, 9C) bf16 folded
    weights (``fold_block_params_wide``); bias: (L, C) f32. Returns bf16
    (B, S, S, C). The weights and bias may be at the kernels' width instead,
    C rounded up to 16 with zero channels (``FusedInference`` pads them
    once).

    On a CUDA tensor this launches the hand-written kernel (one launch per
    conv, each counted in ``trunk_wide.launches``; the shapes of
    :func:`~.build.check_trunk_shape`, x with zero channels up to the
    library's width and the output cut back) or raises; the plain version
    runs only for a tensor on the CPU.
    """
    check_bf16_args(x, w, bias, _wide)

    def launch(xw, ww, bw):
        return launch_bf16_trunk(trunk_wide, bf16_conv_function(
            "trunk_wide", "trunk_wide_conv", build.trunk_shape(xw)), xw, ww, bw)

    return bf16_forward(x, w, bias, wide_at_width, trunk_wide_plain, launch)


trunk_wide.launches = 0


def conv_wide(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv of the trunk with its epilogue (see :func:`conv_wide_plain`):
    h, resid (B, S, S, C) bf16; w (C, 9C) bf16; bias (C,) f32. Launches the
    kernel for a CUDA tensor (counted in ``trunk_wide.launches``), the plain
    version for a CPU one. Lets a check hold each conv against the plain
    version on the same input."""
    check_bf16_args(h, w[None], bias[None], _wide, blocks=False)

    def launch(hw, ww, bw, rw=None):
        return launch_bf16_one_conv(trunk_wide, bf16_conv_function(
            "trunk_wide", "trunk_wide_conv", build.trunk_shape(hw)), hw, ww, bw, rw)

    return bf16_forward(h, w, bias, wide_at_width, conv_wide_plain, launch, resid)
