"""The ``int8_patch`` residual trunk: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel ``_trunk_kernel_int8_patch``
(``othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:230``),
reached through ``fused_trunk_int8(kernel="patch")``. The kernel is
``csrc/trunk_int8_patch.cu``, one launch of the int8 conv body
``csrc/int8_conv_sm90.cuh`` per conv at the variant's block of 32 games:
the Pallas kernel's K = 9C product over a patch of a zero-padded tile is
the body's 36 wgmma k-steps from nine offsets into such a tile. Their notes
state the bounds and the design. It takes the weights K-major, (L, 9, C_out,
C_in) with the taps in ``OFFSETS`` order (:func:`patch_kmajor` of the JAX
package's (L, 9C, C) patch layout), as an 8-bit wgmma reads them.

It computes the ``int8_dx3`` function (per-block activation scale,
per-output-channel weight scale; integer sums are exact in any order), so
its plain version is the plain ``int8_dx3`` trunk on the same weights, and
the two agree bit for bit. :func:`trunk_int8_patch` launches the kernel for
a CUDA tensor and uses :func:`trunk_int8_patch_plain` only for a tensor on
the CPU.
"""

from __future__ import annotations

import torch

from .trunk_int8_dx3 import (check_int8_args, int8_forward, int8_library, int8_plain_trunk,
                             launch_int8_trunk)

DEFAULT_BLOCK_GAMES = 32  # the JAX package's FusedInference default for int8_patch


def patch_kmajor(w: torch.Tensor) -> torch.Tensor:
    """(L, 9C, C) patch weights (rows in ``OFFSETS`` order, then C_in) ->
    (L, 9, C_out, C_in): the int8 conv body's K-major layout; the inverse of
    :func:`kmajor_taps`."""
    L, _, C = w.shape
    return w.reshape(L, 9, C, C).transpose(2, 3).contiguous()


def trunk_int8_patch_plain(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                           bias: torch.Tensor,
                           block_games: int = DEFAULT_BLOCK_GAMES) -> torch.Tensor:
    """Plain PyTorch version of the kernel
    (:func:`~.trunk_int8_dx3.int8_plain_trunk`)."""
    return int8_plain_trunk(x, w, w_scale, bias, block_games)


def trunk_int8_patch(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor, block_games: int = DEFAULT_BLOCK_GAMES) -> torch.Tensor:
    """Int8 residual trunk. x: (B, S, S, C) bf16; w: (L, 9, C_out, C_in)
    int8 K-major weights (:func:`patch_kmajor` of the patch layout); w_scale,
    bias: (L, C) f32. Returns bf16 (B, S, S, C).

    On a CUDA tensor this launches the hand-written kernel (one launch per
    conv, each counted in ``trunk_int8_patch.launches``; the shapes of
    :func:`~.build.check_trunk_shape`, x with zero channels up to the
    library's width and the output cut back) or raises; the plain version
    runs only for a tensor on the CPU. The weights, scales and bias may be
    at that width already (``FusedInference`` pads them once).
    """
    check_int8_args(x, w, w_scale, bias, lambda C: (9, C, C))

    def launch(xw, *args):
        lib = int8_library("trunk_int8_patch", "trunk_patch", xw)
        return launch_int8_trunk(trunk_int8_patch, lib.trunk_patch_prepass, lib.trunk_patch_conv,
                                 xw, *args, block_games)

    return int8_forward(x, w, w_scale, bias, lambda *a: trunk_int8_patch_plain(*a, block_games),
                        launch)


trunk_int8_patch.launches = 0
