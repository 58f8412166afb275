"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU by name. When
CUDA is asked for (explicitly or by default) and absent, they raise instead
of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` or ``"auto"`` -> ``cuda``; ``"cpu"`` -> CPU; any CUDA name
    requires CUDA."""
    device = torch.device("cuda" if name is None or name == "auto" else name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return device
