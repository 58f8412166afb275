"""The ``int8_dxcat`` residual trunk: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel ``_trunk_kernel_int8_dxcat``
(``othello_reinforcement_learning_test_tpu/models/pallas_resnet.py:377``),
reached through ``fused_trunk_int8(kernel="dxcat")``. The kernel is
``csrc/trunk_int8_dxcat.cu``: the whole trunk, pre-pass and every conv, in
one cooperative launch (``csrc/int8_trunk_sm90.cuh``), with the output
channels split across CTAs at the gated iteration's small batches. Their
notes state the bounds and the design. It takes the weights K-major, (L, 9,
C_out, C_in) with the taps in ``OFFSETS`` order (:func:`dxcat_kmajor` of the
JAX package's (L, 3, 3C, C) dxcat layout), as an 8-bit wgmma reads them.

It computes the ``int8_dx3`` function (per-block activation scale,
per-output-channel weight scale; integer sums are exact in any order), so
its plain version is the plain ``int8_dx3`` trunk on the same weights, and
the two agree bit for bit. :func:`trunk_int8_dxcat` launches the kernel for
a CUDA tensor and uses :func:`trunk_int8_dxcat_plain` only for a tensor on
the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .trunk_int8_dx3 import block_size, check_int8_args, int8_forward, int8_plain_trunk

DEFAULT_BLOCK_GAMES = 64  # the JAX package's FusedInference default for int8_dxcat
LAUNCHES_PER_FORWARD = 1  # the whole trunk in one launch


def dxcat_kmajor(w: torch.Tensor) -> torch.Tensor:
    """(L, 3, 3C, C) dxcat weights (dy-major groups, rows (dx block, C_in))
    -> (L, 9, C_out, C_in): the int8 kernels' K-major layout, one (C_out,
    C_in) matrix per tap in :data:`OFFSETS` order (dy-major)."""
    L, _, _, C = w.shape
    wt = w.reshape(L, 3, 3, C, C)  # (L, dy, dx, C_in, C_out)
    return wt.transpose(3, 4).reshape(L, 9, C, C).contiguous()


def trunk_int8_dxcat_plain(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                           bias: torch.Tensor,
                           block_games: int = DEFAULT_BLOCK_GAMES) -> torch.Tensor:
    """Plain PyTorch version of the kernel
    (:func:`~.trunk_int8_dx3.int8_plain_trunk`)."""
    return int8_plain_trunk(x, w, w_scale, bias, block_games)


def _library(x: torch.Tensor) -> ctypes.CDLL:
    """The kernel's library at the shape of ``x`` (a shape
    :func:`~.build.check_trunk_shape` refuses raises first)."""
    lib = build.load("trunk_int8_dxcat", build.trunk_shape(x))
    if lib.trunk_dxcat.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.trunk_dxcat.argtypes = [p] * 8 + [i] * 3 + [p]
        lib.trunk_dxcat.restype = i
    return lib


def _launch(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
            block_games: int) -> torch.Tensor:
    """One host call, one launch of the kernel for the whole trunk, at x's
    (the library's) width."""
    lib = _library(x)
    B, S, _, C = x.shape
    L = w.shape[0]
    bg = block_size(B, block_games)
    with torch.cuda.device(x.device):
        act = B * S * S * C
        # the f32 block input and conv 0 output, then the scratch the call
        # zeroes: the per-block amax of every layer and a barrier counter each
        buf = torch.empty(2 * act + L * (B // bg) + L, dtype=torch.float32, device=x.device)
        out = torch.empty_like(x)
        rc = lib.trunk_dxcat(x.data_ptr(), buf.data_ptr(), buf[act:].data_ptr(),
                             out.data_ptr(), w.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
                             buf[2 * act:].data_ptr(), L, B, bg,
                             torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"trunk_int8_dxcat failed: CUDA error {rc}")
        trunk_int8_dxcat.launches += LAUNCHES_PER_FORWARD
    return out


def trunk_int8_dxcat(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor,
                     block_games: int = DEFAULT_BLOCK_GAMES) -> torch.Tensor:
    """Int8 residual trunk. x: (B, S, S, C) bf16; w: (L, 9, C_out, C_in)
    int8 K-major weights (:func:`dxcat_kmajor` of the dxcat layout);
    w_scale, bias: (L, C) f32. Returns bf16 (B, S, S, C).

    On a CUDA tensor this makes one host call that launches the hand-written
    kernel once for the whole trunk (counted in
    ``trunk_int8_dxcat.launches``; the shapes of
    :func:`~.build.check_trunk_shape`, x with zero channels up to the
    library's width and the output cut back) or raises; the plain version
    runs only for a tensor on the CPU. The weights, scales and bias may be
    at that width already (``FusedInference`` pads them once).
    """
    check_int8_args(x, w, w_scale, bias, lambda C: (9, C, C))
    return int8_forward(x, w, w_scale, bias,
                        lambda *a: trunk_int8_dxcat_plain(*a, block_games),
                        lambda *a: _launch(*a, block_games))


trunk_int8_dxcat.launches = 0
