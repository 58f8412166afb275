"""The reference's PyTorch checkpoint format, TorchScript and ONNX.

Port of ``othello_reinforcement_learning_test_tpu/models/torch_bridge.py``.
The reference persists a model as a ``torch.save`` dict whose
``model_state_dict`` uses the module names of its ``OthelloResNet``
(``conv_block.{conv,bn}``, ``res_blocks.{i}.{conv1,bn1,conv2,bn2}``,
``policy_head.{conv,bn,fc}``, ``value_head.{conv,bn,fc1,fc2}``), and its
loaders re-derive the architecture from those names and shapes.

The port's network already has those names, its policy FC already reads
the NCHW flatten and its BatchNorm the same eps, so the conversion the JAX
package needs (flax HWIO kernels, the policy FC's column permutation) is
the identity here: :func:`to_reference_state_dict` and
:func:`from_reference_state_dict` copy tensors to float32 on the CPU, and
the rest is the file layout. A state dict plays the part of the JAX
package's ``variables``.

ONNX needs the ``onnx`` package, which neither this image nor the card
has: :func:`save_onnx` raises as the JAX function does without it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .export import EvalForward
from .resnet import OthelloResNet


def infer_architecture(state_dict) -> tuple:
    """``(num_blocks, num_filters, board_size, value_hidden)`` from a
    reference-format state dict's key names and shapes (the JAX function
    returns the first three; the value head's width rides along here)."""
    num_filters = int(state_dict["conv_block.conv.weight"].shape[0])
    num_blocks = 1 + max((int(k.split(".")[1]) for k in state_dict
                          if k.startswith("res_blocks.")), default=-1)
    n_actions = int(state_dict["policy_head.fc.weight"].shape[0])
    board_size = int(round((n_actions - 1) ** 0.5))
    return num_blocks, num_filters, board_size, int(state_dict["value_head.fc1.weight"].shape[0])


def to_reference_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict as the reference model's: float32 CPU copies,
    in the network's key order, ``num_batches_tracked`` 0 as the JAX
    export writes it."""
    model = OthelloResNet(*infer_architecture(state_dict))
    sd: Dict[str, Any] = {}
    for key in model.state_dict():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(0, dtype=torch.long)
        else:
            sd[key] = state_dict[key].detach().to("cpu", torch.float32).clone()
    return sd


def from_reference_state_dict(
    state_dict: Dict[str, Any],
) -> Tuple[OthelloResNet, Dict[str, torch.Tensor]]:
    """``(model, state dict)`` computing the same function as a reference
    model with this state dict; the model holds the weights, on the CPU."""
    model = OthelloResNet(*infer_architecture(state_dict))
    sd = to_reference_state_dict(state_dict)
    model.load_state_dict(sd)
    return model, sd


def save_reference_checkpoint(
    state_dict: Dict[str, torch.Tensor],
    path: str,
    config: Optional[Dict] = None,
    global_step: int = 0,
    epoch: int = 0,
) -> str:
    """Write a ``.pt`` checkpoint with the reference trainer's dict shape:
    model, optimizer and scheduler state dicts, ``global_step``, ``epoch``
    and ``config``. The optimizer and scheduler are fresh, as in the JAX
    export: SGD over the network (the reference's parameter order, so its
    state dict equals the JAX export's) and StepLR, from the config's
    ``training`` section."""
    model, sd = from_reference_state_dict(state_dict)
    tr = (config or {}).get("training", {})
    optimizer = torch.optim.SGD(
        model.parameters(),
        # repo configs use training.lr (the reference yamls' key); accept
        # the long form too so that neither spelling falls back silently
        lr=float(tr.get("lr", tr.get("learning_rate", 1e-3))),
        momentum=float(tr.get("momentum", 0.9)),
        weight_decay=float(tr.get("weight_decay", 1e-4)),
    )
    scheduler = torch.optim.lr_scheduler.StepLR(
        optimizer,
        step_size=int(tr.get("lr_step_size", 100)),
        gamma=float(tr.get("lr_gamma", 0.1)),
    )
    torch.save(
        {
            "model_state_dict": sd,
            "optimizer_state_dict": optimizer.state_dict(),
            "scheduler_state_dict": scheduler.state_dict(),
            "global_step": int(global_step),
            "epoch": int(epoch),
            "config": config or {},
        },
        path,
    )
    return path


def load_reference_checkpoint(path: str) -> Tuple[OthelloResNet, Dict[str, torch.Tensor], Dict]:
    """Load a reference ``.pt`` checkpoint (or a bare state dict) into
    ``(model, state dict, config)``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        sd, config = obj["model_state_dict"], obj.get("config", {}) or {}
    else:
        sd, config = obj, {}
    model, sd = from_reference_state_dict(sd)
    return model, sd, config


class ReferenceForward(EvalForward):
    """The reference's I/O contract over the port's eval forward: NCHW
    ``(B, 3, S, S)`` in, ``(log_probs (B, S*S+1), value (B, 1))`` out."""

    def forward(self, x: torch.Tensor):
        return super().forward(x.permute(0, 2, 3, 1))


def _reference_forward(state_dict: Dict[str, torch.Tensor]) -> Tuple[ReferenceForward, int]:
    model, _ = from_reference_state_dict(state_dict)
    return ReferenceForward(model).eval(), model.board_size


def save_torchscript(state_dict: Dict[str, torch.Tensor], path: str,
                     batch_size: int = 1) -> str:
    """Serialize a traced TorchScript module (NCHW input, the reference's
    I/O contract), loadable with ``torch.jit.load`` wherever torch runs."""
    module, board_size = _reference_forward(state_dict)
    dummy = torch.zeros(batch_size, 3, board_size, board_size)
    with torch.no_grad():
        traced = torch.jit.trace(module, (dummy,))
    traced.save(path)
    return path


def save_onnx(state_dict: Dict[str, torch.Tensor], path: str, batch_size: int = 1,
              opset: int = 17) -> str:
    """Export to ONNX with the reference's NCHW ``(B, 3, S, S)`` input.
    Raises RuntimeError when no usable exporter is present (it needs the
    ``onnx`` package); :func:`save_torchscript` and the ``torch.export``
    program (``models/export.py``) need nothing more than torch."""
    module, board_size = _reference_forward(state_dict)
    dummy = torch.zeros(batch_size, 3, board_size, board_size)
    try:
        torch.onnx.export(
            module,
            (dummy,),
            path,
            input_names=["board"],
            output_names=["policy_log_probs", "value"],
            opset_version=opset,
            dynamo=False,
        )
    except Exception as e:  # exporter backends vary by torch build
        raise RuntimeError(f"torch ONNX export unavailable: {e}") from e
    return path
