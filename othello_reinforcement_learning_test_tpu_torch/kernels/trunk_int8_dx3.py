"""The ``int8_dx3`` residual trunk: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel ``_trunk_kernel_int8_dx3``
(``othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:318``),
reached through ``fused_trunk_int8(kernel="dx3")``. The kernel is
``csrc/trunk_int8_dx3.cu``; its note states the bound and the design.

:func:`trunk_int8_dx3` launches the kernel for a CUDA tensor and uses
:func:`trunk_int8_dx3_plain` only for a tensor on the CPU. The plain version
repeats the kernel's arithmetic step for step (the same per-block
activation scale, true division, round half to even, the product
``s_act * w_scale`` taken first, no fused multiply-add), so the two agree
bit for bit; it is the reference the kernel is held against, not a speed
yardstick.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

DEFAULT_BLOCK_GAMES = 64

# Tap order of the dx3 layout (L, 3, C, 3C): dx-major groups, dy-minor
# column blocks within a group.
DX3_OFFSETS = tuple((dy, dx) for dx in (-1, 0, 1) for dy in (-1, 0, 1))


def block_size(num_games: int, block_games: int = DEFAULT_BLOCK_GAMES) -> int:
    """Games per activation-scale block: ``block_games`` halved until it
    divides the batch (the JAX package's ``_grid_call`` rule)."""
    bg = block_games
    while num_games % bg:
        bg //= 2
    return bg


def dx3_tap_weights(w: torch.Tensor) -> torch.Tensor:
    """(L, 3, C, 3C) dx3 weights -> (L, 9C, C) rows ordered as
    :data:`DX3_OFFSETS` then C_in."""
    L, _, C, _ = w.shape
    return w.reshape(L, 3, C, 3, C).permute(0, 1, 3, 2, 4).reshape(L, 9 * C, C)


def div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` as a true division. PyTorch's CUDA division by a Python
    scalar multiplies by the rounded reciprocal instead, which can differ
    by an ulp."""
    return x / torch.full_like(x, 127.0)


def int8_conv3x3(h: torch.Tensor, taps: torch.Tensor,
                 offsets: Sequence[Tuple[int, int]], w_scale: torch.Tensor,
                 bias: torch.Tensor, bg: int) -> torch.Tensor:
    """One folded int8 conv, plain PyTorch. h: (B, S, S, C) f32; taps:
    (9C, C) int8 with rows in ``offsets`` order; one activation scale per
    block of ``bg`` games. Returns f32.

    The integer products are summed in float64, where every partial sum of
    int8 x int8 products over 9 * C terms is an exact integer.
    """
    B, S, _, C = h.shape
    s_act = div127(h.abs().reshape(B // bg, -1).amax(dim=1).clamp_min(1e-8))
    s_rows = s_act.repeat_interleave(bg)
    q = torch.round(h / s_rows[:, None, None, None]).clamp(-127, 127)
    qp = F.pad(q, (0, 0, 1, 1, 1, 1)).to(torch.float64)
    wt = taps.to(torch.float64)
    acc = None
    for k, (dy, dx) in enumerate(offsets):
        part = qp[:, 1 + dy:1 + dy + S, 1 + dx:1 + dx + S, :].reshape(-1, C) \
            @ wt[k * C:(k + 1) * C]
        acc = part if acc is None else acc + part
    scale = s_rows[:, None] * w_scale[None, :]  # (B, C): s_act * w_scale first
    return acc.to(torch.float32).reshape(B, S, S, C) * scale[:, None, None, :] \
        + bias


def int8_trunk(h: torch.Tensor, taps: torch.Tensor,
               offsets: Sequence[Tuple[int, int]], w_scale: torch.Tensor,
               bias: torch.Tensor, bg: int) -> torch.Tensor:
    """The residual tower of :func:`int8_conv3x3` layers, f32 in and out."""
    for i in range(taps.shape[0] // 2):
        y = torch.relu(int8_conv3x3(h, taps[2 * i], offsets, w_scale[2 * i],
                                    bias[2 * i], bg))
        z = int8_conv3x3(y, taps[2 * i + 1], offsets, w_scale[2 * i + 1],
                         bias[2 * i + 1], bg)
        h = torch.relu(h + z)
    return h


def trunk_int8_dx3_plain(x: torch.Tensor, w: torch.Tensor,
                         w_scale: torch.Tensor, bias: torch.Tensor,
                         block_games: int = DEFAULT_BLOCK_GAMES) -> torch.Tensor:
    """Plain PyTorch version of the kernel: bf16 (B, S, S, C) in, bf16 out."""
    bg = block_size(x.shape[0], block_games)
    return int8_trunk(x.to(torch.float32), dx3_tap_weights(w), DX3_OFFSETS,
                      w_scale, bias, bg).to(torch.bfloat16)


def _check(x, w, w_scale, bias) -> int:
    if x.dim() != 4 or x.shape[1] != x.shape[2] or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bf16 (B, S, S, C), got {x.dtype} {tuple(x.shape)}")
    C = x.shape[3]
    if w.dim() != 4 or w.shape[1:] != (3, C, 3 * C) or w.dtype != torch.int8 \
            or w.shape[0] % 2 or w.shape[0] == 0:
        raise ValueError(f"w must be int8 (L, 3, {C}, {3 * C}) with even L > 0, "
                         f"got {w.dtype} {tuple(w.shape)}")
    L = w.shape[0]
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t.shape != (L, C) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 ({L}, {C}), got {t.dtype} {tuple(t.shape)}")
    for t in (w, w_scale, bias):
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got {t.device}")
    for t in (x, w, w_scale, bias):
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    return L


def _library() -> ctypes.CDLL:
    lib = build.load("trunk_int8_dx3")
    if lib.trunk_dx3_conv.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.trunk_dx3_prepass.argtypes = [p, p, p, i, i, i, p]
        lib.trunk_dx3_prepass.restype = i
        lib.trunk_dx3_conv.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.trunk_dx3_conv.restype = i
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"trunk_int8_dx3 {what} failed: CUDA error {rc}")


def trunk_int8_dx3(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                   bias: torch.Tensor,
                   block_games: int = DEFAULT_BLOCK_GAMES) -> torch.Tensor:
    """Int8 residual trunk. x: (B, S, S, C) bf16; w: (L, 3, C, 3C) int8 dx3
    weights; w_scale, bias: (L, C) f32. Returns bf16 (B, S, S, C).

    On a CUDA tensor this launches the hand-written kernel (one launch per
    conv, each counted in ``trunk_int8_dx3.launches``) or raises; the plain
    version runs only for a tensor on the CPU.
    """
    L = _check(x, w, w_scale, bias)
    if x.device.type == "cpu":
        return trunk_int8_dx3_plain(x, w, w_scale, bias, block_games)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, S, _, C = x.shape
    if (S, C) != (8, 128):
        raise ValueError(f"the CUDA kernel takes 8x8 boards and 128 channels, got S={S} C={C}")
    bg = block_size(B, block_games)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        xf = torch.empty((B, S, S, C), dtype=torch.float32, device=x.device)
        yf = torch.empty_like(xf)
        out = torch.empty_like(x)
        amax = torch.empty((L, B // bg), dtype=torch.float32, device=x.device)
        _raise_on(lib.trunk_dx3_prepass(x.data_ptr(), xf.data_ptr(), amax.data_ptr(),
                                        B, bg, L, stream), "pre-pass")
        layer_bytes = 9 * C * C
        for layer in range(L):
            conv1 = layer % 2 == 1
            last = layer == L - 1
            rc = lib.trunk_dx3_conv(
                (yf if conv1 else xf).data_ptr(),
                xf.data_ptr() if conv1 else None,
                None if last else (xf if conv1 else yf).data_ptr(),
                out.data_ptr() if last else None,
                w.data_ptr() + layer * layer_bytes,
                w_scale.data_ptr() + layer * C * 4,
                bias.data_ptr() + layer * C * 4,
                amax.data_ptr(), layer, L, B, bg, int(conv1), int(last), stream)
            _raise_on(rc, f"conv {layer}")
            trunk_int8_dx3.launches += 1
    return out


trunk_int8_dx3.launches = 0
