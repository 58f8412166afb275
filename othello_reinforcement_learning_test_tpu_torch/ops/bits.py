"""64-bit bitboard arithmetic on ``int64`` tensors.

Port of ``othello_reinforcement_learning_test_tpu/ops/bits.py``. The JAX
package keeps a board word as a uint32 pair because the TPU has no 64-bit
integer path; here a word is one ``int64`` element (bit ``i`` is square
``(row=i//8, col=i%8)``, bit 63 is the sign bit). torch on the CPU refuses
shifts on unsigned 64-bit types, so:

- ``<<`` on int64 drops the high bits, which is the logical left shift;
- ``>>`` on int64 is arithmetic, so every right shift is masked afterwards
  to make it logical (the engine's per-direction ``rmask``);
- popcount is a SWAR count over the two 32-bit halves, which keeps every
  intermediate non-negative (no signed overflow).
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def s64(value: int) -> int:
    """Unsigned 64-bit Python int -> the int64 value with the same bits."""
    value &= 0xFFFFFFFFFFFFFFFF
    return value - (1 << 64) if value >= 1 << 63 else value


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Number of set bits -> int32 of the same shape."""
    lo = x & _MASK32
    hi = (x >> 32) & _MASK32
    return (_popcount32(lo) + _popcount32(hi)).to(torch.int32)


def bit(pos: torch.Tensor) -> torch.Tensor:
    """One-hot int64 word for bit index ``pos``; 0 where pos is outside
    [0, 63] (e.g. the pass action's -1)."""
    pos = pos.to(torch.int64)
    valid = (pos >= 0) & (pos < 64)
    one = torch.ones_like(pos) << pos.clamp(0, 63)
    return torch.where(valid, one, torch.zeros_like(one))


def to_planes(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(...) int64 word -> (..., 64) per-square values in {0, 1}."""
    idx = torch.arange(64, dtype=torch.int64, device=x.device)
    return ((x[..., None] >> idx) & 1).to(dtype)


def from_planes(planes: torch.Tensor) -> torch.Tensor:
    """(..., 64) boolean/0-1 values -> (...) int64 word."""
    idx = torch.arange(64, dtype=torch.int64, device=planes.device)
    # distinct bits never carry, so the sum is the bitwise OR
    return ((planes != 0).to(torch.int64) << idx).sum(dim=-1)
