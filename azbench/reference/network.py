"""Plain forward of the dual-head ResNet as the configuration serves it.

The benchmark's reference for the network, worked out from the raw
weights (a state dict of the upstream layout: ``conv_block``,
``res_blocks.{i}``, ``policy_head``, ``value_head``, BatchNorm with its
running statistics). It folds the BatchNorm and quantizes the tower
itself, and rounds where the configuration's precision rounds:

- stem: bf16 weights and 3x3 convolution, output rounded to bf16, eval
  BatchNorm in f32 as ``x * g + b`` with ``g = gamma / sqrt(var + eps)``
  (the root taken in float64 and rounded once), ReLU, rounded to bf16;
- tower: each 3x3 convolution with its BatchNorm folded in (weights times
  ``g``, rounded to bf16), quantized to ``levels`` (127: int8) with one
  scale per output channel, activations quantized with one scale per block
  of ``block_games`` consecutive positions of the batch, the integer
  products summed exactly, then ``acc * (s_act * w_scale) + bias`` in f32;
  ``relu(h + conv2(relu(conv1(h))))`` per block; the output rounded to
  bf16;
- heads: 1x1 convolutions and dense layers in bf16 (each product rounded
  to bf16), their BatchNorm, biases and ReLU in f32; softmax and tanh in
  float64.

Sums of products are taken in float64, where they are exact or nearly so,
and rounded to the configuration's type where it rounds. With ``levels``
7 the same network runs its tower in int4: the control that the check has
to refuse.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """An exact float64 sum as a bf16 result: rounded to f32, then to bf16."""
    return x.to(f32).to(bf16)


def bn_affine(sd: Dict[str, torch.Tensor], prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm ``prefix`` as ``x * g + b`` (f32)."""
    root = torch.sqrt((sd[f"{prefix}.running_var"] + BN_EPS).to(f64)).to(f32)
    g = sd[f"{prefix}.weight"] / root
    return g, sd[f"{prefix}.bias"] - sd[f"{prefix}.running_mean"] * g


def quantize_conv(sd: Dict[str, torch.Tensor], conv: str, bn: str, levels: int):
    """A tower conv with its BatchNorm folded in: (9, C_in, C_out) codes as
    f64 in TAPS order, the (C_out,) f32 scale and bias."""
    g, b = bn_affine(sd, bn)
    w = (sd[f"{conv}.weight"].permute(2, 3, 1, 0) * g).to(bf16).to(f32)  # (3, 3, in, out)
    absmax = w.abs().amax(dim=(0, 1, 2)).clamp_min(1e-8)
    scale = absmax / torch.full_like(absmax, float(levels))
    codes = torch.round(w / scale).clamp(-levels, levels)
    return codes.reshape(9, *codes.shape[2:]).to(f64), scale, b


class PlainNet:
    """``(N, 8, 8, 3) f32 -> (log_probs (N, 65), value (N,))``, float64,
    for N a multiple of ``block_games``."""

    def __init__(self, sd: Dict[str, torch.Tensor], blocks: int, levels: int = 127,
                 block_games: int = 64):
        self.levels, self.block_games = levels, block_games
        self.stem_w = sd["conv_block.conv.weight"].to(bf16).to(f64)
        self.stem_g, self.stem_b = bn_affine(sd, "conv_block.bn")
        self.tower = [quantize_conv(sd, f"res_blocks.{i}.conv{j}", f"res_blocks.{i}.bn{j}",
                                    levels)
                      for i in range(blocks) for j in (1, 2)]
        self.p_conv = sd["policy_head.conv.weight"][:, :, 0, 0].t().to(bf16).to(f64)
        self.p_g, self.p_b = bn_affine(sd, "policy_head.bn")
        self.p_fc = sd["policy_head.fc.weight"].t().to(bf16).to(f64)
        self.p_fc_b = sd["policy_head.fc.bias"]
        self.v_conv = sd["value_head.conv.weight"][:, :, 0, 0].t().to(bf16).to(f64)
        self.v_g, self.v_b = bn_affine(sd, "value_head.bn")
        self.v_fc1 = sd["value_head.fc1.weight"].t().to(bf16).to(f64)
        self.v_fc1_b = sd["value_head.fc1.bias"]
        self.v_fc2 = sd["value_head.fc2.weight"].t().to(bf16).to(f64)
        self.v_fc2_b = sd["value_head.fc2.bias"]

    def conv(self, h: torch.Tensor, layer) -> torch.Tensor:
        codes, w_scale, bias = layer
        n, s, _, c = h.shape
        bg = self.block_games
        amax = h.abs().reshape(n // bg, -1).amax(dim=1).clamp_min(1e-8)
        s_act = (amax / torch.full_like(amax, float(self.levels))).repeat_interleave(bg)
        q = torch.round(h / s_act[:, None, None, None]).clamp(-self.levels, self.levels)
        qp = F.pad(q.to(f64), (0, 0, 1, 1, 1, 1))
        acc = torch.zeros((n * s * s, codes.shape[2]), dtype=f64, device=h.device)
        for k, (dy, dx) in enumerate(TAPS):
            acc += qp[:, 1 + dy:1 + dy + s, 1 + dx:1 + dx + s, :].reshape(-1, c) @ codes[k]
        scale = s_act[:, None] * w_scale[None, :]
        return acc.to(f32).reshape(n, s, s, -1) * scale[:, None, None, :] + bias

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        n = x.shape[0]
        if n % self.block_games:
            raise ValueError(f"a batch of {n} is not whole blocks of {self.block_games}")
        h = F.conv2d(x.permute(0, 3, 1, 2).to(f64), self.stem_w, padding=1)
        h = torch.relu(bf16_round(h).permute(0, 2, 3, 1).to(f32) * self.stem_g + self.stem_b)
        h = h.to(bf16).to(f32)
        for i in range(0, len(self.tower), 2):
            y = torch.relu(self.conv(h, self.tower[i]))
            h = torch.relu(h + self.conv(y, self.tower[i + 1]))
        h = h.to(bf16).to(f64)
        p = torch.relu(bf16_round(h @ self.p_conv).to(f32) * self.p_g + self.p_b)
        p = p.permute(0, 3, 1, 2).reshape(n, -1)
        logits = bf16_round(p.to(bf16).to(f64) @ self.p_fc).to(f32) + self.p_fc_b
        v = torch.relu(bf16_round(h @ self.v_conv).to(f32) * self.v_g + self.v_b).reshape(n, -1)
        v = torch.relu(bf16_round(v.to(bf16).to(f64) @ self.v_fc1).to(f32) + self.v_fc1_b)
        v = bf16_round(v.to(bf16).to(f64) @ self.v_fc2).to(f32) + self.v_fc2_b
        return torch.log_softmax(logits.to(f64), dim=-1), torch.tanh(v.to(f64))[:, 0]

    def in_chunks(self, x: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`__call__` over ``chunk`` positions at a time (a multiple of
        ``block_games``), which bounds its memory."""
        parts = [self(part) for part in x.split(chunk)]
        return torch.cat([p for p, _ in parts]), torch.cat([v for _, v in parts])


def masked_probs(log_probs: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """The policy over legal actions, renormalized; uniform over them where
    the network puts no mass on any."""
    p = torch.exp(log_probs) * legal
    total = p.sum(dim=-1, keepdim=True)
    uniform = legal / legal.sum(dim=-1, keepdim=True).clamp_min(1)
    return torch.where(total > 1e-8, p / total.clamp_min(1e-300), uniform)
