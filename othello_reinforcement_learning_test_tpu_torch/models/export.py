"""Model export via ``torch.export``.

Port of ``othello_reinforcement_learning_test_tpu/models/export.py``, whose
serving format is a serialized StableHLO program (``jax.export``). Here it
is a ``torch.export`` program: the eval-mode forward, float32, weights
baked in, at a fixed batch, saved with ``torch.export.save`` and run again
with ``torch.export.load`` on any device torch runs on. Input and outputs
are the JAX export's: NHWC ``(B, S, S, 3)`` in, ``(log_probs, value)``
out.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from .resnet import OthelloResNet


class EvalForward(nn.Module):
    """``model``'s eval forward in float32, the module that is exported."""

    def __init__(self, model: OthelloResNet):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.model(x, train=False, compute_dtype=torch.float32)


def export_forward(model: OthelloResNet, batch_size: int = 256) -> torch.export.ExportedProgram:
    """Export ``model``'s eval-mode forward for a fixed batch size, on the
    device its weights are on."""
    s = model.board_size
    x = torch.zeros(batch_size, s, s, 3, device=next(model.parameters()).device)
    with torch.no_grad():
        return torch.export.export(EvalForward(model).eval(), (x,))


def save_exported(model: OthelloResNet, path: str, batch_size: int = 256) -> str:
    """Write the exported forward to ``path`` with ``torch.export.save``,
    and its graph as readable text beside it (``<path>.txt``). Replaces
    the JAX package's ``save_stablehlo`` (and its ``.mlir`` sidecar).

    The program keeps the device of ``model``'s weights: one traced on the
    CPU, as ``cli export`` traces it, runs on the card only after
    ``torch.export.passes.move_to_device_pass``, which
    :func:`load_exported` applies when given a device."""
    exported = export_forward(model, batch_size)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(exported, path)
    with open(path + ".txt", "w") as f:
        f.write(str(exported.graph_module.code))
    return path


def load_exported(path: str, device: Optional[Union[str, torch.device]] = None
                  ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Read an exported forward and return ``fn(x) -> (log_probs, value)``
    running on ``device`` (where it was exported when not given). Replaces
    the JAX package's ``load_stablehlo``."""
    from torch.export.passes import move_to_device_pass

    exported = torch.export.load(path)
    if device is not None:
        exported = move_to_device_pass(exported, torch.device(device))
    module = exported.module()

    def fn(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            return module(x)

    return fn
