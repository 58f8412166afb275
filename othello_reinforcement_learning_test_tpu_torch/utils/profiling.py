"""Profiling and tracing utilities.

Port of ``othello_reinforcement_learning_test_tpu/utils/profiling.py``:

- :class:`PhaseTimer`: per-phase wall timers whose fence waits for the
  device (kernels are launched asynchronously, so without it time lands in
  the wrong phase);
- :func:`trace`: a ``torch.profiler`` trace of the CPU and CUDA activity,
  written as a Chrome trace (``chrome://tracing`` or Perfetto);
- :func:`speed_of_light`: measured throughput beside the compute bound of
  the device's dense bf16 peak, with :func:`model_flops_per_board`.

The JAX package's table of TPU peaks has no counterpart: the only peak
here is the H100's.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional, Union

import torch

# dense bf16 tensor-core peak, FLOP/s, from NVIDIA's H100 data sheet (half
# its figures with sparsity): PCIe 756, NVL 835.5, SXM 989.4 TFLOP/s. The
# SXM part reports itself as "NVIDIA H100 80GB HBM3", so it is the last match
H100_BF16_FLOPS = {"h100 pcie": 756e12, "h100 nvl": 835.5e12, "h100": 989.4e12}


def _synchronize(fence) -> None:
    """Wait for the device work behind ``fence``: a tensor (or a list or
    tuple of them) or a device."""
    if isinstance(fence, (list, tuple)):
        for f in fence:
            _synchronize(f)
        return
    device = fence.device if isinstance(fence, torch.Tensor) else torch.device(fence)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates wall time per named phase; fences device work."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                _synchronize(fence)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1),
            }
            for k in self.totals
        }

    def report(self) -> str:
        lines = ["phase              total      calls     mean"]
        for k, v in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"{k:18s} {v['total_s']:8.2f}s {v['count']:8d} "
                f"{v['mean_s'] * 1e3:8.2f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` trace of the block, CUDA activity included when
    there is a card, written to ``<log_dir>/trace.json`` (Chrome format).
    Yields the profiler, or ``None`` when disabled."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_flops_per_sec(
        device: Optional[Union[str, torch.device]] = None) -> Optional[float]:
    """Dense bf16 peak FLOP/s of an H100, matched on the card's name;
    ``None`` for any other device (the CPU included)."""
    device = torch.device(device if device is not None
                          else "cuda" if torch.cuda.is_available() else "cpu")
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in H100_BF16_FLOPS.items():
        if key in name:
            return peak
    return None


def speed_of_light(
    env_steps_per_sec: float,
    net_boards_per_sec: float,
    model_flops_per_board: float,
    device: Optional[Union[str, torch.device]] = None,
) -> str:
    """Compare measured throughput to simple upper bounds."""
    peak = device_flops_per_sec(device)
    name = device if device is not None else (
        torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu")
    lines = [f"device: {name}"]
    lines.append(f"env steps/s (measured):     {env_steps_per_sec:,.0f}")
    lines.append(f"net boards/s (measured):    {net_boards_per_sec:,.0f}")
    if peak:
        bound = peak / max(model_flops_per_board, 1.0)
        frac = net_boards_per_sec / bound if bound else 0.0
        lines.append(
            f"net boards/s (compute bound {peak/1e12:.0f} TFLOP/s bf16): "
            f"{bound:,.0f}  -> {frac:.1%} of peak"
        )
    return "\n".join(lines)


def model_flops_per_board(num_blocks: int = 10, num_filters: int = 128,
                          board_size: int = 8) -> float:
    """Forward FLOPs per board for the dual-head ResNet (2x MACs)."""
    s2 = board_size * board_size
    f = num_filters
    stem = 2 * s2 * 9 * 3 * f
    blocks = num_blocks * 2 * (2 * s2 * 9 * f * f)
    policy = 2 * s2 * f * 2 + 2 * (2 * s2) * (s2 + 1)
    value = 2 * s2 * f * 1 + 2 * s2 * 256 + 2 * 256
    return float(stem + blocks + policy + value)
