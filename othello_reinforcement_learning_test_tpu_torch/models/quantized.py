"""Int8 quantized residual trunk: weights and the whole-batch plain trunk.

Port of ``othello_reinforcement_learning_test_tpu/models/quantized.py``.

- weights: BatchNorm folded in eval mode, then symmetric int8 with one
  scale per output channel, shared by the nine taps and all input channels;
- activations: dynamic symmetric int8, one scale per tensor.

:func:`plain_int8_trunk` (the JAX package's ``xla_int8_trunk``) takes its
activation scale over the whole batch; the ``int8_dx3`` kernel
(``kernels/trunk_int8_dx3.py``) takes it per block of games. The two share
the weights and the conv arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.trunk_int8_dx3 import div127, int8_trunk
from .fused_resnet import fold_block_params
from .resnet import OthelloResNet

# 3x3 neighbourhood offsets, row-major as in the HWIO kernel: tap k of the
# (L, C, 9C) layout is OFFSETS[k]
OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


class QuantizedTrunk(NamedTuple):
    """Folded and quantized trunk parameters.

    w_int8: (L, C, 9C) int8; tap k's (C_in, C_out) matrix is in columns
        [k*C, (k+1)*C), k row-major over (dy, dx) in (-1, 0, 1)^2.
    w_scale: (L, C) f32 per-output-channel dequantisation scale.
    bias: (L, C) f32 folded BatchNorm bias.
    """

    w_int8: torch.Tensor
    w_scale: torch.Tensor
    bias: torch.Tensor


def quantize_trunk(model: OthelloResNet) -> QuantizedTrunk:
    """Fold eval-mode BN into the trunk convs and quantize them to int8."""
    w, bias = fold_block_params(model)  # (L, 3, 3, C, C) bf16
    w = w.to(torch.float32)
    L, _, _, C, _ = w.shape
    absmax = w.abs().amax(dim=(1, 2, 3))  # (L, C_out)
    scale = div127(absmax.clamp_min(1e-8))
    q = torch.round(w / scale[:, None, None, None, :]).clamp(-127, 127).to(torch.int8)
    q = q.reshape(L, 9, C, C).permute(0, 2, 1, 3).reshape(L, C, 9 * C)
    return QuantizedTrunk(q.contiguous(), scale, bias)


def quantize_activations(h: torch.Tensor):
    """Dynamic symmetric per-tensor int8: returns (q_int8, scale_f32)."""
    s = div127(h.abs().amax().clamp_min(1e-8))
    q = torch.round(h / s).clamp(-127, 127).to(torch.int8)
    return q, s


def plain_int8_trunk(h: torch.Tensor, qt: QuantizedTrunk) -> torch.Tensor:
    """The quantized trunk with one activation scale per whole batch.

    h: (B, S, S, C) f32 stem output (post-ReLU). Returns f32.
    """
    L, C, _ = qt.w_int8.shape
    taps = qt.w_int8.reshape(L, C, 9, C).permute(0, 2, 1, 3).reshape(L, 9 * C, C)
    return int8_trunk(h, taps, OFFSETS, qt.w_scale, qt.bias, bg=h.shape[0])
