"""Dual-head policy/value ResNet as a PyTorch module.

Port of ``othello_reinforcement_learning_test_tpu/models/resnet.py``. The
layers are NCHW inside, as PyTorch's convolutions want, but the interface
keeps the JAX layout: input ``(B, S, S, 3)`` NHWC, output
``(log_probs (B, S*S+1), value (B, 1))``. The module names follow the
reference checkpoint format (``conv_block``, ``res_blocks.{i}``,
``policy_head``, ``value_head``), so a state dict from
``models/convert.py`` loads with ``strict=True``.

The port holds the network in float32 and evaluates it in eval mode
(BatchNorm running statistics, eps 1e-5, as flax's default). The self-play
path runs the stem, the int8 trunk and the heads through
``models/fused_resnet.FusedInference`` instead.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class ConvBlock(nn.Module):
    """Stem: Conv3x3 (no bias) - BN - ReLU."""

    def __init__(self, in_ch: int, filters: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, filters, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(filters, eps=1e-5)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class ResBlock(nn.Module):
    """Conv-BN-ReLU-Conv-BN + skip, final ReLU."""

    def __init__(self, filters: int):
        super().__init__()
        self.conv1 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters, eps=1e-5)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(filters, eps=1e-5)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(x + y)


class PolicyHead(nn.Module):
    """Conv1x1(2) - BN - ReLU - FC - LogSoftmax. The FC input is the NCHW
    flatten (channel-major), the reference's order."""

    def __init__(self, filters: int, board_size: int):
        super().__init__()
        ss = board_size * board_size
        self.conv = nn.Conv2d(filters, 2, 1, bias=False)
        self.bn = nn.BatchNorm2d(2, eps=1e-5)
        self.fc = nn.Linear(2 * ss, ss + 1)

    def forward(self, x):
        p = torch.relu(self.bn(self.conv(x)))
        return torch.log_softmax(self.fc(p.flatten(1)), dim=-1)


class ValueHead(nn.Module):
    """Conv1x1(1) - BN - ReLU - FC(hidden) - ReLU - FC(1) - Tanh."""

    def __init__(self, filters: int, board_size: int, hidden: int):
        super().__init__()
        self.conv = nn.Conv2d(filters, 1, 1, bias=False)
        self.bn = nn.BatchNorm2d(1, eps=1e-5)
        self.fc1 = nn.Linear(board_size * board_size, hidden)
        self.fc2 = nn.Linear(hidden, 1)

    def forward(self, x):
        v = torch.relu(self.bn(self.conv(x)))
        v = torch.relu(self.fc1(v.flatten(1)))
        return torch.tanh(self.fc2(v))


class OthelloResNet(nn.Module):
    """``(B, S, S, 3) -> (log_probs (B, S*S+1), value (B, 1))``."""

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

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.conv_block(x.to(torch.float32).permute(0, 3, 1, 2))
        for blk in self.res_blocks:
            h = blk(h)
        return self.policy_head(h), self.value_head(h)
