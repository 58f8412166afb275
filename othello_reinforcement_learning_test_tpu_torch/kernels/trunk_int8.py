"""The ``int8`` (output-shift) residual trunk: CUDA kernel wrapper and plain
version.

Replaces the Pallas TPU kernel ``_trunk_kernel_int8``
(``othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:149``),
reached through ``fused_trunk_int8(kernel="out_shift")`` (variant ``int8``)
and, with ``stage_bf16``, ``kernel="out_shift_bf16"`` (variant
``int8_bf16``). The kernel is ``csrc/trunk_int8.cu``, one launch of the
int8 conv body ``csrc/int8_conv_sm90.cuh`` per conv; their notes state the
bounds and the design. It takes the weights K-major, (L, 9, C_out, C_in)
with the taps in ``OFFSETS`` order (:func:`kmajor_weights`), as an 8-bit
wgmma reads them.

The int32 path computes the ``int8_dx3`` function (per-block activation
scale, per-output-channel weight scale; integer sums are exact in any
order), so its plain version is the plain ``int8_dx3`` trunk on the same
K-major weights, and the kernel is the same conv body's int32 mode. With
``stage_bf16`` each tap's int32 product is rounded to bf16 before an f32 sum
from zero in ``OFFSETS`` order, and the plain version rounds in the same
place: through f32, as XLA converts int32 to bf16 (above 2^24 that can round
twice). :func:`trunk_int8` launches the kernel for
a CUDA tensor and uses :func:`trunk_int8_plain` only for a tensor on the
CPU; the two agree bit for bit.
"""

from __future__ import annotations

import torch

from .trunk_int8_dx3 import (check_int8_args, int8_forward, int8_library, int8_plain_trunk,
                             launch_int8_trunk)

DEFAULT_BLOCK_GAMES = 16  # the JAX package's FusedInference default for int8


def tap_major(w: torch.Tensor) -> torch.Tensor:
    """(L, C, 9C) int8 weights, tap k's (C_in, C_out) block in columns
    [k*C, (k+1)*C) -> (L, 9C, C) rows ordered as :data:`OFFSETS` then C_in."""
    L, C, _ = w.shape
    return w.reshape(L, C, 9, C).permute(0, 2, 1, 3).reshape(L, 9 * C, C)


def kmajor_weights(w: torch.Tensor) -> torch.Tensor:
    """(L, C, 9C) tap-major int8 weights -> (L, 9, C_out, C_in): the int8
    kernels' K-major layout, one (C_out, C_in) matrix per tap in
    :data:`OFFSETS` order, which the ``stage_bf16`` sum keeps."""
    L, C, _ = w.shape
    return w.reshape(L, C, 9, C).permute(0, 2, 3, 1).contiguous()


def trunk_int8_plain(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor, block_games: int = DEFAULT_BLOCK_GAMES,
                     stage_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel
    (:func:`~.trunk_int8_dx3.int8_plain_trunk`)."""
    return int8_plain_trunk(x, w, w_scale, bias, block_games, stage_bf16)


def trunk_int8(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
               bias: torch.Tensor, block_games: int = DEFAULT_BLOCK_GAMES,
               stage_bf16: bool = False) -> torch.Tensor:
    """Int8 residual trunk. x: (B, S, S, C) bf16; w: (L, 9, C_out, C_in)
    int8 K-major weights (:func:`kmajor_weights` of ``quantize_trunk``'s
    layout); w_scale, bias: (L, C) f32. Returns bf16 (B, S, S, C).

    On a CUDA tensor this launches the hand-written kernel (one launch per
    conv, each counted in ``trunk_int8.launches``; the shapes of
    :func:`~.build.check_trunk_shape`, x with zero channels up to the
    library's width and the output cut back) or raises; the plain version
    runs only for a tensor on the CPU. The weights, scales and bias may be
    at that width already (``FusedInference`` pads them once).
    """
    check_int8_args(x, w, w_scale, bias, lambda C: (9, C, C))

    def launch(xw, *args):
        lib = int8_library("trunk_int8", "trunk_int8", xw, num_flags=1)
        return launch_int8_trunk(trunk_int8, lib.trunk_int8_prepass, lib.trunk_int8_conv, xw,
                                 *args, block_games, int(stage_bf16))

    return int8_forward(x, w, w_scale, bias,
                        lambda *a: trunk_int8_plain(*a, block_games, stage_bf16), launch)


trunk_int8.launches = 0
