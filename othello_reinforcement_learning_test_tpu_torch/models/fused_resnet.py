"""Eval-mode forward with the hand-written trunk kernel.

Host half of ``othello_reinforcement_learning_test_tpu/models/
pallas_resnet.py``: BatchNorm folding, the weight relayouts of each trunk
kernel, the per-variant block sizes and ``FusedInference``. The stem and
the two heads are plain bf16 PyTorch ops, as the JAX package leaves them to
XLA; the residual tower goes through a hand-written kernel:

- ``matmul9``: ``kernels/trunk_matmul9.py``; ``wide``: ``kernels/trunk_wide.py``;
- ``int8`` and ``int8_bf16``: ``kernels/trunk_int8.py``;
- ``int8_m9``, ``int8_patch``, ``int8_flat``, ``int8_dx3`` and
  ``int8_dxcat``: ``kernels/trunk_int8_m9.py``, ``trunk_int8_patch.py``,
  ``trunk_int8_flat.py``, ``trunk_int8_dx3.py`` and ``trunk_int8_dxcat.py``.

Variant ``int8_xla`` has no kernel in the JAX package either: it is the
plain quantized trunk with one activation scale per batch, on both devices.
Every variant of the JAX package's ``FusedInference.VARIANTS`` is ported.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..kernels import build
from ..kernels.trunk_int8 import kmajor_weights, tap_major, trunk_int8
from ..kernels.trunk_int8_dx3 import dx3_kmajor, int8_at_width, trunk_int8_dx3
from ..kernels.trunk_int8_dxcat import dxcat_kmajor, trunk_int8_dxcat
from ..kernels.trunk_int8_flat import trunk_int8_flat
from ..kernels.trunk_int8_m9 import m9_kmajor, trunk_int8_m9
from ..kernels.trunk_int8_patch import patch_kmajor, trunk_int8_patch
from ..kernels.trunk_matmul9 import at_width, hwio_at_width, trunk_matmul9
from ..kernels.trunk_wide import trunk_wide, wide_at_width
from .resnet import OthelloResNet

BN_EPS = 1e-5
PORTED_VARIANTS = ("int8_dx3", "matmul9", "wide", "int8", "int8_bf16", "int8_m9",
                   "int8_patch", "int8_flat", "int8_dxcat", "int8_xla")
# games per activation-scale block when ``block_games`` is 0: the JAX
# package's table (``pallas_resnet.py:619-623``); halved until it divides
# the batch. 0 for int8_xla: one scale per batch.
DEFAULT_BLOCK_GAMES = {"matmul9": 32, "wide": 16, "int8": 16, "int8_bf16": 16,
                       "int8_m9": 32, "int8_patch": 32, "int8_flat": 32, "int8_dx3": 64,
                       "int8_dxcat": 64, "int8_xla": 0}


def _bn_affine(bn: torch.nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as ``v * g + b`` with g = gamma / sqrt(var + eps),
    b = beta - mean * g (f32). The square root is the correctly rounded f32
    one, taken in float64 and rounded once, as XLA's and CUDA's are:
    PyTorch's vectorized f32 ``sqrt`` on the CPU is an ulp off near ties,
    which moves a folded bf16 weight and, through the int8 codes, the
    quantized trunk (one channel of a trained 10x128 network)."""
    root = torch.sqrt((bn.running_var + BN_EPS).to(torch.float64)).to(torch.float32)
    g = bn.weight / root
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


@torch.no_grad()
def fold_block_params_wide(model: OthelloResNet) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded trunk laid out for the ``wide`` kernel: (w (L, C, 9C)
    bf16, bias (L, C) f32), tap k's (C_in, C_out) block in columns
    [k*C, (k+1)*C), k row-major over (dy, dx)."""
    w, b = fold_block_params(model)
    L, _, _, C, _ = w.shape
    return w.reshape(L, 9, C, C).permute(0, 2, 1, 3).reshape(L, C, 9 * C).contiguous(), b


def dx3_weights(w_int8: torch.Tensor) -> torch.Tensor:
    """(L, C, 9C) tap-major int8 weights (tap k = 3*(dy+1) + dx+1) ->
    (L, 3, C, 3C): dx-major groups, dy-minor column blocks in each group."""
    L, C, _ = w_int8.shape
    wt = w_int8.reshape(L, C, 3, 3, C)  # (L, C_in, dy, dx, C_out)
    return wt.permute(0, 3, 1, 2, 4).reshape(L, 3, C, 3 * C).contiguous()


def dx3_kmajor_weights(w_int8: torch.Tensor) -> torch.Tensor:
    """(L, C, 9C) tap-major int8 weights -> the ``int8_dx3`` kernel's
    (L, 9, C_out, C_in): the JAX package's dx3 layout, relaid out K-major."""
    return dx3_kmajor(dx3_weights(w_int8))


def dxcat_weights(w_int8: torch.Tensor) -> torch.Tensor:
    """(L, C, 9C) tap-major int8 weights -> (L, 3, 3C, C): dy-major groups,
    rows (dx block, C_in)-major to match the lane-concatenated input."""
    L, C, _ = w_int8.shape
    wt = w_int8.reshape(L, C, 3, 3, C)  # (L, C_in, dy, dx, C_out)
    return wt.permute(0, 2, 3, 1, 4).reshape(L, 3, 3 * C, C).contiguous()


def dxcat_kmajor_weights(w_int8: torch.Tensor) -> torch.Tensor:
    """(L, C, 9C) tap-major int8 weights -> the ``int8_dxcat`` kernel's
    (L, 9, C_out, C_in): the JAX package's dxcat layout, relaid out K-major."""
    return dxcat_kmajor(dxcat_weights(w_int8))


def patch_kmajor_weights(w_int8: torch.Tensor) -> torch.Tensor:
    """(L, C, 9C) tap-major int8 weights -> the ``int8_patch`` and
    ``int8_flat`` kernels' (L, 9, C_out, C_in): the JAX package's patch and
    flat layout (L, 9C, C), relaid out K-major."""
    return patch_kmajor(tap_major(w_int8))


def m9_kmajor_weights(w_int8: torch.Tensor) -> torch.Tensor:
    """(L, C, 9C) tap-major int8 weights -> the ``int8_m9`` kernel's
    (L, 9, C_out, C_in): the JAX package's m9 layout (L, 9, C_in, C_out),
    one square matrix a tap, relaid out K-major."""
    L, C, _ = w_int8.shape
    return m9_kmajor(w_int8.reshape(L, C, 9, C).permute(0, 2, 1, 3))


# the int8 kernel variants: the trunk, and how it takes the (L, C, 9C)
# weights relaid out
INT8_KERNELS = {
    "int8": (trunk_int8, kmajor_weights),
    "int8_bf16": (functools.partial(trunk_int8, stage_bf16=True), kmajor_weights),
    "int8_dx3": (trunk_int8_dx3, dx3_kmajor_weights),
    "int8_m9": (trunk_int8_m9, m9_kmajor_weights),
    "int8_patch": (trunk_int8_patch, patch_kmajor_weights),
    "int8_flat": (trunk_int8_flat, patch_kmajor_weights),
    "int8_dxcat": (trunk_int8_dxcat, dxcat_kmajor_weights),
}


class FusedInference:
    """Eval-mode ``(B, S, S, 3) -> (log_probs (B, A), value (B, 1))`` with a
    trunk kernel. The weights are folded (and for the int8 variants
    quantized and relaid out for the variant's kernel) once, here, from
    ``model``'s current parameters, on ``model``'s device: build a new
    instance after the parameters change.

    ``block_games`` (0: the variant's entry of :data:`DEFAULT_BLOCK_GAMES`,
    as in the JAX package) is halved until it divides the batch. For the
    int8 kernel variants it is part of the output: the activation scale is
    taken per block of that many games. ``int8_xla`` takes one scale per
    batch, and ``matmul9`` and ``wide`` have no per-block scale, so for them
    it has no numeric effect.

    - ``matmul9``: bf16 folded weights (L, 3, 3, C, C), f32 biases (L, C);
    - ``wide``: the same weights as (L, C, 9C); each tap's product is
      rounded to bf16 before the shifted f32 sum;
    - ``int8``, ``int8_bf16``, ``int8_dx3``, ``int8_m9``, ``int8_patch``,
      ``int8_flat``, ``int8_dxcat``: the quantized trunk in the K-major
      (L, 9, C_out, C_in) layout of the int8 wgmma kernels, each relaid out
      from the JAX package's layout for that variant; ``int8_bf16`` rounds
      each tap's product to bf16.

    At a width C that is not a multiple of 16 the kernel variants' weights,
    scales and biases are padded here, once, with zero channels to the
    kernels' width (:func:`~..kernels.build.padded_channels`); each trunk
    call pads only the activations and cuts its output back to C channels.
    Zero channels change no output value.
    """

    def __init__(self, model: OthelloResNet, variant: str = "int8_dx3",
                 block_games: int = 0):
        if variant not in PORTED_VARIANTS:
            raise ValueError(f"variant must be one of {PORTED_VARIANTS}, got {variant!r}")
        # quantized.py imports fold_block_params from this module
        from .quantized import quantize_trunk

        self.variant = variant
        self.block_games = block_games or DEFAULT_BLOCK_GAMES[variant]
        self.board_size = model.board_size
        bf16 = torch.bfloat16
        with torch.no_grad():
            stem = model.conv_block
            self.stem_w = stem.conv.weight.to(bf16)
            self.stem_g, self.stem_b = _bn_affine(stem.bn)
            if variant.startswith("int8"):
                self.qt = quantize_trunk(model)
                self.trunk_w = (INT8_KERNELS[variant][1](self.qt.w_int8)
                                if variant in INT8_KERNELS else self.qt.w_int8)
                self.trunk_scale = self.qt.w_scale.contiguous()
                self.trunk_bias = self.qt.bias.contiguous()
            else:
                fold = fold_block_params_wide if variant == "wide" else fold_block_params
                w, b = fold(model)
                self.trunk_w, self.trunk_bias = w.contiguous(), b.contiguous()
            width = build.padded_channels(model.num_filters)
            if variant in INT8_KERNELS:
                self.trunk_w, self.trunk_scale, self.trunk_bias = int8_at_width(
                    self.trunk_w, self.trunk_scale, self.trunk_bias, width)
            elif variant in ("matmul9", "wide"):
                self.trunk_w = (wide_at_width if variant == "wide" else hwio_at_width)(
                    self.trunk_w, width)
                self.trunk_bias = at_width(self.trunk_bias, (1,), width)
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
        v = self.variant
        if v == "matmul9":
            return trunk_matmul9(h, self.trunk_w, self.trunk_bias)
        if v == "wide":
            return trunk_wide(h, self.trunk_w, self.trunk_bias)
        if v == "int8_xla":
            from .quantized import plain_int8_trunk
            return plain_int8_trunk(h.to(torch.float32), self.qt).to(torch.bfloat16)
        return INT8_KERNELS[v][0](h, self.trunk_w, self.trunk_scale, self.trunk_bias,
                                  self.block_games)

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
