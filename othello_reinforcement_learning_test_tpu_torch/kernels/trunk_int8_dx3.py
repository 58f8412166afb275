"""The ``int8_dx3`` residual trunk: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel ``_trunk_kernel_int8_dx3``
(``othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:318``),
reached through ``fused_trunk_int8(kernel="dx3")``. The kernel is
``csrc/trunk_int8_dx3.cu``, one launch of the int8 conv body
``csrc/int8_conv_sm90.cuh`` per conv; their notes state the bounds and the
design. It takes the weights K-major, (L, 9, C_out, C_in) with the taps in
``OFFSETS`` order (:func:`dx3_kmajor`), as an 8-bit wgmma reads them.

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
from .trunk_matmul9 import OFFSETS, at_width, run_at_width, weight_width

DEFAULT_BLOCK_GAMES = 64


def block_size(num_games: int, block_games: int = DEFAULT_BLOCK_GAMES) -> int:
    """Games per activation-scale block: ``block_games`` halved until it
    divides the batch (the JAX package's ``_grid_call`` rule)."""
    bg = block_games
    while num_games % bg:
        bg //= 2
    return bg


def dx3_kmajor(w: torch.Tensor) -> torch.Tensor:
    """(L, 3, C, 3C) dx3 weights (dx-major groups, dy-minor column blocks)
    -> (L, 9, C_out, C_in): the int8 kernels' K-major layout, one
    (C_out, C_in) matrix per tap in :data:`OFFSETS` order (dy-major)."""
    L, _, C, _ = w.shape
    wt = w.reshape(L, 3, C, 3, C)  # (L, dx, C_in, dy, C_out)
    return wt.permute(0, 3, 1, 4, 2).reshape(L, 9, C, C).contiguous()


def kmajor_taps(w: torch.Tensor) -> torch.Tensor:
    """(L, 9, C_out, C_in) K-major weights -> (L, 9C, C): rows ordered as
    the taps, then C_in, as :func:`int8_trunk` takes them."""
    L, _, C, _ = w.shape
    return w.transpose(2, 3).reshape(L, 9 * C, C)


def div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` as a true division. PyTorch's CUDA division by a Python
    scalar multiplies by the rounded reciprocal instead, which can differ
    by an ulp."""
    return x / torch.full_like(x, 127.0)


def int8_conv3x3(h: torch.Tensor, taps: torch.Tensor,
                 offsets: Sequence[Tuple[int, int]], w_scale: torch.Tensor,
                 bias: torch.Tensor, bg: int, stage_bf16: bool = False) -> torch.Tensor:
    """One folded int8 conv, plain PyTorch. h: (B, S, S, C) f32; taps:
    (9C, C) int8 with rows in ``offsets`` order; one activation scale per
    block of ``bg`` games. Returns f32.

    The integer products are summed in float64, where every partial sum of
    int8 x int8 products over 9 * C terms is an exact integer. With
    ``stage_bf16`` (the ``int8_bf16`` variant) each tap's integer product is
    instead rounded to bf16 through f32, as XLA converts int32 to bf16, and
    the taps are summed in f32 from zero in ``offsets`` order.
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
        if stage_bf16:
            part = part.to(torch.float32).to(torch.bfloat16).to(torch.float32)
        acc = part if acc is None else acc + part
    scale = s_rows[:, None] * w_scale[None, :]  # (B, C): s_act * w_scale first
    return acc.to(torch.float32).reshape(B, S, S, C) * scale[:, None, None, :] \
        + bias


def int8_trunk(h: torch.Tensor, taps: torch.Tensor,
               offsets: Sequence[Tuple[int, int]], w_scale: torch.Tensor,
               bias: torch.Tensor, bg: int, stage_bf16: bool = False) -> torch.Tensor:
    """The residual tower of :func:`int8_conv3x3` layers, f32 in and out."""
    for i in range(taps.shape[0] // 2):
        y = torch.relu(int8_conv3x3(h, taps[2 * i], offsets, w_scale[2 * i],
                                    bias[2 * i], bg, stage_bf16))
        z = int8_conv3x3(y, taps[2 * i + 1], offsets, w_scale[2 * i + 1],
                         bias[2 * i + 1], bg, stage_bf16)
        h = torch.relu(h + z)
    return h


def int8_plain_trunk(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor, block_games: int,
                     stage_bf16: bool = False) -> torch.Tensor:
    """The plain version the int8 kernels share: bf16 (B, S, S, C) in, bf16
    out, any S and C; w as the kernels take it, (L, 9, C_out, C_in), at C or
    at the kernels' width (x padded to it, the output cut back)."""
    bg = block_size(x.shape[0], block_games)
    return run_at_width(x, w.shape[-1], lambda xw: int8_trunk(
        xw.to(torch.float32), kmajor_taps(w), OFFSETS, w_scale, bias, bg,
        stage_bf16).to(torch.bfloat16))


def trunk_int8_dx3_plain(x: torch.Tensor, w: torch.Tensor,
                         w_scale: torch.Tensor, bias: torch.Tensor,
                         block_games: int = DEFAULT_BLOCK_GAMES) -> torch.Tensor:
    """Plain PyTorch version of the kernel (:func:`int8_plain_trunk`)."""
    return int8_plain_trunk(x, w, w_scale, bias, block_games)


def check_int8_args(x, w, w_scale, bias, w_tail) -> int:
    """Check an int8 trunk's arguments; ``w_tail(C)`` is the weights' shape
    after L, at x's width C or padded (:func:`~.trunk_matmul9.weight_width`).
    Returns L."""
    if x.dim() != 4 or x.shape[1] != x.shape[2] or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bf16 (B, S, S, C), got {x.dtype} {tuple(x.shape)}")
    C = weight_width(x, w, w_tail)
    if C is None or w.dtype != torch.int8 or w.shape[0] % 2 or w.shape[0] == 0:
        C = x.shape[3]
        raise ValueError(f"w must be int8 (L, {', '.join(map(str, w_tail(C)))}) with even "
                         f"L > 0, got {w.dtype} {tuple(w.shape)}")
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


def int8_at_width(w: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
                  width: int) -> tuple:
    """(L, 9, C_out, C_in) weights, their (L, C) scales and bias with zero
    channels up to ``width`` (itself where they are there)."""
    return at_width(w, (2, 3), width), at_width(w_scale, (1,), width), at_width(bias, (1,), width)


def int8_forward(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
                 plain, launch) -> torch.Tensor:
    """An int8 trunk: ``plain(x, w, w_scale, bias)`` for a tensor on the
    CPU, ``launch(...)`` for a CUDA one at the kernels' width
    (:func:`~.build.trunk_shape`, which refuses other shapes first): x and
    the weights with zero channels up to it, the output cut back to x's.
    Zero channels leave every per-block amax as it was and quantize to 0,
    so the output is the same bit for bit."""
    if x.device.type == "cpu":
        return plain(x, w, w_scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    width = build.trunk_shape(x)[1]
    w, w_scale, bias = int8_at_width(w, w_scale, bias, width)
    return run_at_width(x, width, lambda xw: launch(xw, w, w_scale, bias))


def int8_library(name: str, prefix: str, x: torch.Tensor, num_flags: int = 0) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu`` at the shape of the trunk input ``x`` (built
    on first use; a shape :func:`~.build.check_trunk_shape` refuses raises
    first) and declare its ``<prefix>_prepass`` and ``<prefix>_conv``;
    ``num_flags`` is the count of the conv's own trailing int arguments."""
    lib = build.load(name, build.trunk_shape(x))
    prepass, conv = getattr(lib, f"{prefix}_prepass"), getattr(lib, f"{prefix}_conv")
    if conv.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        prepass.argtypes = [p, p, p, i, i, i, p]
        prepass.restype = i
        conv.argtypes = [p] * 8 + [i] * (6 + num_flags) + [p]
        conv.restype = i
    return lib


def launch_int8_trunk(wrapper, prepass, conv, x: torch.Tensor, w: torch.Tensor,
                      w_scale: torch.Tensor, bias: torch.Tensor, block_games: int,
                      *flags: int) -> torch.Tensor:
    """The launch sequence the int8 trunk kernels share: one pre-pass (bf16
    input to f32, the first layer's per-block amax), then one ``conv``
    launch per layer, each counted in ``wrapper.launches``; ``flags`` are
    the kernel's own trailing arguments, ``prepass`` and ``conv`` those of
    the library at x's shape (:func:`int8_library`)."""
    B, S, _, C = x.shape
    L = w.shape[0]
    bg = block_size(B, block_games)

    def raise_on(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{wrapper.__name__} {what} failed: CUDA error {rc}")

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        xf = torch.empty((B, S, S, C), dtype=torch.float32, device=x.device)
        yf = torch.empty_like(xf)
        out = torch.empty_like(x)
        amax = torch.empty((L, B // bg), dtype=torch.float32, device=x.device)
        raise_on(prepass(x.data_ptr(), xf.data_ptr(), amax.data_ptr(), B, bg, L, stream),
                 "pre-pass")
        for layer in range(L):
            conv1 = layer % 2 == 1
            last = layer == L - 1
            rc = conv(
                (yf if conv1 else xf).data_ptr(),
                xf.data_ptr() if conv1 else None,
                None if last else (xf if conv1 else yf).data_ptr(),
                out.data_ptr() if last else None,
                w[layer].data_ptr(), w_scale[layer].data_ptr(), bias[layer].data_ptr(),
                amax.data_ptr(), layer, L, B, bg, int(conv1), int(last), *flags, stream)
            raise_on(rc, f"conv {layer}")
            wrapper.launches += 1
    return out


def trunk_int8_dx3(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                   bias: torch.Tensor,
                   block_games: int = DEFAULT_BLOCK_GAMES) -> torch.Tensor:
    """Int8 residual trunk. x: (B, S, S, C) bf16; w: (L, 9, C_out, C_in)
    int8 K-major weights (:func:`dx3_kmajor` of the dx3 layout); w_scale,
    bias: (L, C) f32. Returns bf16 (B, S, S, C).

    The weights, scales and bias may be at the kernels' width instead, C
    rounded up to 16 with zero channels (``FusedInference`` pads them once).

    On a CUDA tensor this launches the hand-written kernel (one launch per
    conv, each counted in ``trunk_int8_dx3.launches``; x with zero channels
    up to the library's width, :func:`int8_forward`) or raises; the plain
    version runs only for a tensor on the CPU.
    """
    check_int8_args(x, w, w_scale, bias, lambda C: (9, C, C))

    def launch(xw, *args):
        lib = int8_library("trunk_int8_dx3", "trunk_dx3", xw)
        return launch_int8_trunk(trunk_int8_dx3, lib.trunk_dx3_prepass, lib.trunk_dx3_conv,
                                 xw, *args, block_games)

    return int8_forward(x, w, w_scale, bias,
                        lambda *a: trunk_int8_dx3_plain(*a, block_games), launch)


trunk_int8_dx3.launches = 0
