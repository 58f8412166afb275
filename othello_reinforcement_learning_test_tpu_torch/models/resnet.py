"""Dual-head policy/value ResNet as a PyTorch module.

Port of ``othello_reinforcement_learning_test_tpu/models/resnet.py``. The
layers are NCHW inside, as PyTorch's convolutions want, but the interface
keeps the JAX layout: input ``(B, S, S, 3)`` NHWC, output
``(log_probs (B, S*S+1), value (B, 1))``. The module names follow the
reference checkpoint format (``conv_block``, ``res_blocks.{i}``,
``policy_head``, ``value_head``), so a state dict from
``models/convert.py`` loads with ``strict=True``.

Parameters and BatchNorm statistics are float32. ``forward(x, train,
compute_dtype)`` follows flax's semantics, which PyTorch's defaults do not
give:

- ``compute_dtype`` is the type the convolutions, dense layers and
  activations run in (the JAX network uses bfloat16, ``float32`` reproduces
  ``OthelloResNet(dtype=jnp.float32)``); BatchNorm statistics and the
  normalisation itself are float32, then cast back, as flax does;
- ``train=True`` normalises with the batch statistics, mean and *biased*
  variance taken as E[x^2] - E[x]^2 (flax's fast variance), and updates
  the running statistics in place as ``ra = 0.99 * ra + 0.01 * batch``;
- ``train=False`` uses the running statistics (eps 1e-5).

The module's own ``train()``/``eval()`` mode is not read: ``train`` is an
argument, as in flax. The self-play path runs the stem, the trunk kernel
and the heads through ``models/fused_resnet.FusedInference`` instead.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.99  # flax nn.BatchNorm default: ra = m * ra + (1 - m) * batch


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over (N, H, W) with flax's train-mode semantics (see the
    module docstring); state-dict keys as ``nn.BatchNorm2d``."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=1 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), padding=conv.padding)


def _dense(fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return x @ fc.weight.to(x.dtype).t() + fc.bias.to(x.dtype)


class ConvBlock(nn.Module):
    """Stem: Conv3x3 (no bias) - BN - ReLU."""

    def __init__(self, in_ch: int, filters: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, filters, 3, padding=1, bias=False)
        self.bn = BatchNorm(filters)

    def forward(self, x, train: bool = False):
        return torch.relu(self.bn(_conv(self.conv, x), train))


class ResBlock(nn.Module):
    """Conv-BN-ReLU-Conv-BN + skip, final ReLU."""

    def __init__(self, filters: int):
        super().__init__()
        self.conv1 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(filters)

    def forward(self, x, train: bool = False):
        y = torch.relu(self.bn1(_conv(self.conv1, x), train))
        y = self.bn2(_conv(self.conv2, y), train)
        return torch.relu(x + y)


class PolicyHead(nn.Module):
    """Conv1x1(2) - BN - ReLU - FC - LogSoftmax. The FC input is the NCHW
    flatten (channel-major), the reference's order."""

    def __init__(self, filters: int, board_size: int):
        super().__init__()
        ss = board_size * board_size
        self.conv = nn.Conv2d(filters, 2, 1, bias=False)
        self.bn = BatchNorm(2)
        self.fc = nn.Linear(2 * ss, ss + 1)

    def forward(self, x, train: bool = False):
        p = torch.relu(self.bn(_conv(self.conv, x), train))
        return torch.log_softmax(_dense(self.fc, p.flatten(1)).to(torch.float32), dim=-1)


class ValueHead(nn.Module):
    """Conv1x1(1) - BN - ReLU - FC(hidden) - ReLU - FC(1) - Tanh."""

    def __init__(self, filters: int, board_size: int, hidden: int):
        super().__init__()
        self.conv = nn.Conv2d(filters, 1, 1, bias=False)
        self.bn = BatchNorm(1)
        self.fc1 = nn.Linear(board_size * board_size, hidden)
        self.fc2 = nn.Linear(hidden, 1)

    def forward(self, x, train: bool = False):
        v = torch.relu(self.bn(_conv(self.conv, x), train))
        v = torch.relu(_dense(self.fc1, v.flatten(1)))
        return torch.tanh(_dense(self.fc2, v).to(torch.float32))


class OthelloResNet(nn.Module):
    """``(B, S, S, 3) -> (log_probs (B, S*S+1), value (B, 1))``, both f32."""

    def __init__(self, num_blocks: int = 10, num_filters: int = 128,
                 board_size: int = 8, value_hidden: int = 256):
        super().__init__()
        self.num_blocks = num_blocks
        self.num_filters = num_filters
        self.board_size = board_size
        self.value_hidden = value_hidden
        self.conv_block = ConvBlock(3, num_filters)
        self.res_blocks = nn.ModuleList(
            [ResBlock(num_filters) for _ in range(num_blocks)])
        self.policy_head = PolicyHead(num_filters, board_size)
        self.value_head = ValueHead(num_filters, board_size, value_hidden)

    def forward(self, x: torch.Tensor, train: bool = False,
                compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.conv_block(x.to(compute_dtype).permute(0, 3, 1, 2), train)
        for blk in self.res_blocks:
            h = blk(h, train)
        return self.policy_head(h, train), self.value_head(h, train)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
