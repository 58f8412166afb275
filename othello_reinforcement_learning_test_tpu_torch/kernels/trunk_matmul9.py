"""The bf16 ``matmul9`` residual trunk: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel ``_trunk_kernel``
(``othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:61``),
reached through ``fused_trunk`` (variant ``"matmul9"``). The kernel is
``csrc/trunk_matmul9.cu``; its note states the bound and the design.

:func:`trunk_matmul9` launches the kernel for a CUDA tensor and uses
:func:`trunk_matmul9_plain` only for a tensor on the CPU. The plain version
takes the same steps as the kernel (the nine shifted products of
bf16-valued tensors summed in f32 from the bias, the ReLU, the residual add
in f32, the bf16 roundings in the same places); it sums in another order,
so the two agree to bf16 rounding, not bit for bit. It is the reference the
kernel is held against, not a speed yardstick.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from . import build

# 3x3 neighbourhood offsets, row-major as the HWIO kernel's (kh, kw) axes
OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def weight_width(x: torch.Tensor, w: torch.Tensor, w_tail) -> Optional[int]:
    """The channel width of a trunk's weights: x's own C, or the kernels'
    width (C rounded up to 16, :func:`~.build.padded_channels`) where they
    were padded with zero channels once (``FusedInference``); None if
    ``w.shape[1:]`` is ``w_tail`` of neither."""
    C = x.shape[3]
    for width in (C, build.padded_channels(C)):
        if w.dim() == 1 + len(w_tail(width)) and tuple(w.shape[1:]) == w_tail(width):
            return width
    return None


def at_width(t: torch.Tensor, dims: Sequence[int], width: int) -> torch.Tensor:
    """``t`` with zeros appended along each of ``dims`` up to ``width``
    (itself where it is there): zero channels add exact zeros to every sum,
    quantize to 0 and stay 0 through a zero bias and ReLU."""
    pad = [0] * (2 * t.dim())
    for d in dims:
        pad[2 * (t.dim() - 1 - d) + 1] = width - t.shape[d]
    return F.pad(t, pad) if any(pad) else t


def run_at_width(x: torch.Tensor, width: int, fn: Callable[..., torch.Tensor],
                 *like_x: Optional[torch.Tensor]) -> torch.Tensor:
    """``fn(x, *like_x)`` with x (B, S, S, C) and the tensors shaped like it
    (None stays None) given zero channels up to ``width``, the output cut
    back to C channels."""
    C = x.shape[3]
    if width == C:
        return fn(x, *like_x)
    pad = [None if t is None else at_width(t, (3,), width) for t in (x, *like_x)]
    return fn(*pad)[..., :C].contiguous()


def conv3x3(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """One folded conv, plain PyTorch. h: (B, S, S, C) bf16; w: (3, 3, C, C)
    bf16; bias: (C,) f32. Returns the f32 accumulator ``bias + sum_k
    shift_k(h) @ w_k`` (each product of bf16 values exact in f32)."""
    B, S, _, C = h.shape
    hp = F.pad(h.to(torch.float32), (0, 0, 1, 1, 1, 1))
    wf = w.to(torch.float32)
    acc = bias.expand(B * S * S, C)
    for dy, dx in OFFSETS:
        acc = acc + hp[:, 1 + dy:1 + dy + S, 1 + dx:1 + dx + S, :].reshape(-1, C) \
            @ wf[1 + dy, 1 + dx]
    return acc.reshape(B, S, S, C)


def conv_plain(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv with its epilogue, bf16 out: ``relu(acc)`` for the first
    conv of a block, ``relu(f32(resid) + acc)`` for the second. w and bias
    may be at the kernels' width (h and resid are padded to it)."""
    def conv(hw, rw):
        z = conv3x3(hw, w, bias)
        if rw is not None:
            z = rw.to(torch.float32) + z
        return torch.relu(z).to(torch.bfloat16)
    return run_at_width(h, bias.shape[-1], conv, resid)


def sum_error_bound(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """How far two correct f32 accumulations of one conv may differ: each
    sums n = 9C + 10 terms (the products, the nine tap adds, the bias) and
    errs by at most n * 2^-24 * sum|terms| (the standard bound for a
    floating-point sum), so two of them by twice that. sum|terms| is the
    same conv on absolute values. Near an output of zero this exceeds
    PyTorch's bf16 ``atol`` of 1e-5, whatever the two summation orders are.
    At the weights' width, C rounded up to 16 where they are padded."""
    n = 9 * bias.shape[-1] + 10
    return run_at_width(h, bias.shape[-1],
                        lambda hw: 2 * n * 2.0 ** -24 * conv3x3(hw.abs(), w.abs(), bias.abs()))


def trunk_matmul9_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: bf16 (B, S, S, C) in, bf16 out;
    w and bias at C or at the kernels' width."""
    def trunk(h):
        for i in range(w.shape[0] // 2):
            y = conv_plain(h, w[2 * i], bias[2 * i])
            h = conv_plain(y, w[2 * i + 1], bias[2 * i + 1], resid=h)
        return h
    return run_at_width(x, bias.shape[-1], trunk)


def check_bf16_args(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, w_tail,
                    blocks: bool = True) -> int:
    """Check a bf16 trunk's (or, with ``blocks=False``, one conv's)
    arguments; ``w_tail(C)`` is the weights' shape after L, at x's width C or
    padded (:func:`weight_width`). Returns L."""
    if x.dim() != 4 or x.shape[1] != x.shape[2] or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bf16 (B, S, S, C), got {x.dtype} {tuple(x.shape)}")
    C = weight_width(x, w, w_tail)
    if C is None or w.dtype != torch.bfloat16 or (blocks and w.shape[0] % 2) or w.shape[0] == 0:
        C = x.shape[3]
        raise ValueError(f"w must be bf16 (L, {', '.join(map(str, w_tail(C)))}) with even "
                         f"L > 0, got {w.dtype} {tuple(w.shape)}")
    L = w.shape[0]
    if bias.shape != (L, C) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be f32 ({L}, {C}), got {bias.dtype} {tuple(bias.shape)}")
    for t in (w, bias):
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got {t.device}")
    for t in (x, w, bias):
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return L


@functools.cache
def bf16_conv_function(name: str, symbol: str, shape: tuple):
    """``symbol`` of ``csrc/<name>.cu`` at ``shape`` (S, C) (built on first
    use), declared as a bf16 conv: (in, resid, out, w, bias, B, is_conv1,
    stream). Resolved once a shape."""
    fn = getattr(build.load(name, shape), symbol)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 5 + [i] * 2 + [p]
    fn.restype = i
    return fn


def launch_bf16_conv(wrapper, fn, stream: int, batch: int, h: int, resid: Optional[int],
                     out: int, w_layer: int, bias_layer: int) -> None:
    """One conv launch on ``stream`` from data pointers (``resid`` None for
    the first conv of a block), counted in ``wrapper.launches``."""
    rc = fn(h, resid, out, w_layer, bias_layer, batch, int(resid is not None), stream)
    if rc != 0:
        what = (f"CUDA error {rc}" if rc > 0
                else f"tensor-map encoding failed, CUresult {-rc}")
        raise RuntimeError(f"{wrapper.__name__} conv kernel failed: {what}")
    wrapper.launches += 1


def launch_bf16_trunk(wrapper, fn, x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """The launch sequence the bf16 trunk kernels share: one launch per
    conv, the second conv of a block updating the block's output in place.
    The stream and every pointer are taken before the first launch."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        y = torch.empty_like(x)
        out = torch.empty_like(x)
        batch, xp, yp, op = x.shape[0], x.data_ptr(), y.data_ptr(), out.data_ptr()
        w0, w_step = w.data_ptr(), w[0].numel() * w.element_size()
        b0, b_step = bias.data_ptr(), bias.shape[1] * bias.element_size()
        for i in range(0, w.shape[0], 2):
            h = xp if i == 0 else op  # the block's input; conv 1 updates out in place
            launch_bf16_conv(wrapper, fn, stream, batch, h, None, yp, w0 + i * w_step,
                             b0 + i * b_step)
            launch_bf16_conv(wrapper, fn, stream, batch, yp, h, op, w0 + (i + 1) * w_step,
                             b0 + (i + 1) * b_step)
    return out


def check_resid(h: torch.Tensor, resid: Optional[torch.Tensor]) -> None:
    if resid is not None and (resid.shape != h.shape or resid.dtype != h.dtype
                              or resid.device != h.device or not resid.is_contiguous()):
        raise ValueError("resid must be a contiguous tensor like h")


def bf16_forward(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, w_at_width,
                 plain, launch, resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A bf16 trunk (or one conv, with ``resid``): ``plain(x, w, bias[,
    resid])`` for a tensor on the CPU, ``launch(...)`` for a CUDA one at the
    kernels' width (:func:`~.build.trunk_shape`, which refuses other shapes
    first): x (and resid) with zero channels up to it, the weights by
    ``w_at_width(w, width)``, the output cut back to x's."""
    check_resid(x, resid)
    if x.device.type == "cpu":
        return plain(x, w, bias) if resid is None else plain(x, w, bias, resid)
    width = build.trunk_shape(x)[1]
    w, bias = w_at_width(w, width), at_width(bias, (bias.dim() - 1,), width)
    if resid is None:
        return run_at_width(x, width, lambda xw: launch(xw, w, bias))
    return run_at_width(x, width, lambda xw, rw: launch(xw, w, bias, rw), resid)


def launch_bf16_one_conv(wrapper, fn, h, w, bias, resid) -> torch.Tensor:
    """One conv with its epilogue on the card."""
    with torch.cuda.device(h.device):
        out = torch.empty_like(h)
        launch_bf16_conv(wrapper, fn, torch.cuda.current_stream().cuda_stream, h.shape[0],
                         h.data_ptr(), None if resid is None else resid.data_ptr(),
                         out.data_ptr(), w.data_ptr(), bias.data_ptr())
    return out


def _hwio(C: int) -> tuple:
    return (3, 3, C, C)


def hwio_at_width(w: torch.Tensor, width: int) -> torch.Tensor:
    """(..., 3, 3, C, C) HWIO weights with zero channels in and out up to
    ``width``."""
    return at_width(w, (w.dim() - 2, w.dim() - 1), width)


def trunk_matmul9(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """bf16 residual trunk. x: (B, S, S, C) bf16; w: (L, 3, 3, C, C) bf16
    folded weights (HWIO); bias: (L, C) f32. Returns bf16 (B, S, S, C).
    The weights and bias may be at the kernels' width instead, C rounded up
    to 16 with zero channels (``FusedInference`` pads them once).

    On a CUDA tensor this launches the hand-written kernel (one launch per
    conv, each counted in ``trunk_matmul9.launches``; x with zero channels
    up to the width of :func:`~.build.trunk_shape`, the output cut back) or
    raises; the plain version runs only for a tensor on the CPU.
    """
    check_bf16_args(x, w, bias, _hwio)

    def launch(xw, ww, bw):
        return launch_bf16_trunk(trunk_matmul9, bf16_conv_function(
            "trunk_matmul9", "trunk_m9_conv", build.trunk_shape(xw)), xw, ww, bw)

    return bf16_forward(x, w, bias, hwio_at_width, trunk_matmul9_plain, launch)


trunk_matmul9.launches = 0


def conv_matmul9(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv of the trunk with its epilogue (see :func:`conv_plain`):
    h, resid (B, S, S, C) bf16; w (3, 3, C, C) bf16; bias (C,) f32. Launches
    the kernel for a CUDA tensor (counted in ``trunk_matmul9.launches``),
    the plain version for a CPU one. Lets a check hold each conv against
    the plain version on the same input."""
    check_bf16_args(h, w[None], bias[None], _hwio, blocks=False)

    def launch(hw, ww, bw, rw=None):
        return launch_bf16_one_conv(trunk_matmul9, bf16_conv_function(
            "trunk_matmul9", "trunk_m9_conv", build.trunk_shape(hw)), hw, ww, bw, rw)

    return bf16_forward(h, w, bias, hwio_at_width, conv_plain, launch, resid)
