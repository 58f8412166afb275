"""Eval-mode forward with the hand-written trunk kernel.

Host half of ``othello_reinforcement_learning_test_tpu/models/
pallas_resnet.py``: BatchNorm folding, the dx3 weight relayout, the
block-size rule and ``FusedInference``. The stem and the two heads are
plain bf16 PyTorch ops, as the JAX package leaves them to XLA; the residual
tower goes through ``kernels/trunk_int8_dx3.py``.

Only the ``int8_dx3`` variant is ported. ``ROADMAP.md`` lists the other
nine variants of the JAX package's ``FusedInference.VARIANTS`` as not yet
ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.trunk_int8_dx3 import DEFAULT_BLOCK_GAMES, trunk_int8_dx3
from .resnet import OthelloResNet

BN_EPS = 1e-5


def _bn_affine(bn: torch.nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as ``v * g + b`` with g = gamma / sqrt(var + eps),
    b = beta - mean * g (f32)."""
    g = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return g, bn.bias - bn.running_mean * g


@torch.no_grad()
def fold_block_params(model: OthelloResNet) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BatchNorm into the trunk's conv weights and biases.

    Returns (weights (L, 3, 3, C, C) bf16 in HWIO order, bias (L, C) f32)
    with L = 2 * num_blocks, ordered [block0.conv1, block0.conv2, ...].
    """
    ws, bs = [], []
    for blk in model.res_blocks:
        for conv, bn in ((blk.conv1, blk.bn1), (blk.conv2, blk.bn2)):
            g, b = _bn_affine(bn)
            w = conv.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO
            ws.append((w * g[None, None, None, :]).to(torch.bfloat16))
            bs.append(b.to(torch.float32))
    return torch.stack(ws), torch.stack(bs)


def dx3_weights(w_int8: torch.Tensor) -> torch.Tensor:
    """(L, C, 9C) tap-major int8 weights (tap k = 3*(dy+1) + dx+1) ->
    (L, 3, C, 3C): dx-major groups, dy-minor column blocks in each group."""
    L, C, _ = w_int8.shape
    wt = w_int8.reshape(L, C, 3, 3, C)  # (L, C_in, dy, dx, C_out)
    return wt.permute(0, 3, 1, 2, 4).reshape(L, 3, C, 3 * C).contiguous()


class FusedInference:
    """Eval-mode ``(B, S, S, 3) -> (log_probs (B, A), value (B, 1))`` with
    the int8 trunk kernel; the weights are folded, quantized and relaid out
    once, from ``model``'s current parameters, on ``model``'s device. The
    activation scale is taken per block of 64 games (halved until it divides
    the batch), the JAX package's default for ``int8_dx3``."""

    def __init__(self, model: OthelloResNet, variant: str = "int8_dx3"):
        if variant != "int8_dx3":
            raise ValueError(
                f"variant {variant!r} is not ported: ROADMAP.md lists it as "
                "not yet ported; only 'int8_dx3' is")
        # quantized.py imports fold_block_params from this module
        from .quantized import quantize_trunk

        self.variant = variant
        self.board_size = model.board_size
        bf16 = torch.bfloat16
        with torch.no_grad():
            stem = model.conv_block
            self.stem_w = stem.conv.weight.to(bf16)
            self.stem_g, self.stem_b = _bn_affine(stem.bn)
            qt = quantize_trunk(model)
            self.trunk_w = dx3_weights(qt.w_int8)
            self.trunk_scale = qt.w_scale.contiguous()
            self.trunk_bias = qt.bias.contiguous()
            ph, vh = model.policy_head, model.value_head
            self.p_conv = ph.conv.weight[:, :, 0, 0].t().to(bf16)  # (C, 2)
            self.p_g, self.p_b = _bn_affine(ph.bn)
            self.p_fc_w = ph.fc.weight.t().to(bf16)  # (2*S*S NCHW, A)
            self.p_fc_b = ph.fc.bias.clone()
            self.v_conv = vh.conv.weight[:, :, 0, 0].t().to(bf16)  # (C, 1)
            self.v_g, self.v_b = _bn_affine(vh.bn)
            self.v_fc1_w, self.v_fc1_b = vh.fc1.weight.t().to(bf16), vh.fc1.bias.clone()
            self.v_fc2_w, self.v_fc2_b = vh.fc2.weight.t().to(bf16), vh.fc2.bias.clone()

    @torch.no_grad()
    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, S, S, C) bf16: bf16 conv, f32 BN + ReLU,
        rounded to bf16 for the trunk."""
        h = torch.nn.functional.conv2d(
            x.to(torch.bfloat16).permute(0, 3, 1, 2), self.stem_w, padding=1)
        h = torch.relu(h.permute(0, 2, 3, 1).to(torch.float32) * self.stem_g
                       + self.stem_b)
        return h.to(torch.bfloat16).contiguous()

    def trunk(self, h: torch.Tensor) -> torch.Tensor:
        return trunk_int8_dx3(h, self.trunk_w, self.trunk_scale,
                              self.trunk_bias, DEFAULT_BLOCK_GAMES)

    @torch.no_grad()
    def heads(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """bf16 trunk output -> (log_probs (B, A) f32, value (B, 1) f32)."""
        bf16, f32 = torch.bfloat16, torch.float32
        B = h.shape[0]
        p = torch.relu((h @ self.p_conv).to(f32) * self.p_g + self.p_b)  # (B,S,S,2)
        p = p.permute(0, 3, 1, 2).reshape(B, -1)  # NCHW flatten, as p_fc_w
        logits = (p.to(bf16) @ self.p_fc_w).to(f32) + self.p_fc_b
        log_probs = torch.log_softmax(logits, dim=-1)

        v = torch.relu((h @ self.v_conv).to(f32) * self.v_g + self.v_b)
        v = v.reshape(B, -1)
        v = torch.relu((v.to(bf16) @ self.v_fc1_w).to(f32) + self.v_fc1_b)
        v = (v.to(bf16) @ self.v_fc2_w).to(f32) + self.v_fc2_b
        return log_probs, torch.tanh(v)

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.heads(self.trunk(self.stem(x)))
