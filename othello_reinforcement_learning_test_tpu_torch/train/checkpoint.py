"""Checkpoints of the full training state, one ``torch.save`` file each.

Port of ``othello_reinforcement_learning_test_tpu/train/checkpoint.py``.
A checkpoint is a file ``<name>.pt`` with two JSON sidecars beside it:
``<path>.meta.json`` (format, buffer class and capacity) and
``<path>.config.json`` (the run's config).

- format 1 (:func:`save`): a bare train state;
- format 2 (:func:`save_full`): ``{"train_state", "buffer", "rng"[, "best"],
  "format": 2}``. The train state is ``{"model": state dict in the
  reference's keys, "optimizer": the SGD momentum buffers, "step",
  "iteration"}``; the buffer is its tensors and counters; ``rng`` holds the
  trainer's generator states; the config is in the file too. Resuming from
  it reproduces an uninterrupted run bit for bit.

The JAX package's checkpoints are orbax directories; reading them needs
JAX, so this module cannot load them: ``scripts/orbax_to_torch.py``, which
imports both packages, converts one into a format-1 file. Files are loaded with ``weights_only=True``: tensors, numbers,
strings, lists and dicts only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

FORMAT = 2
SUFFIX = ".pt"


def _write(path: str, obj: Dict, config: Optional[Dict]) -> str:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader never sees a partial file
    if config is not None:
        with open(path + ".config.json", "w") as f:
            json.dump(config, f, indent=2, default=str)
    return path


def save(path: str, state: Dict, config: Optional[Dict] = None) -> str:
    """Format 1: the train state alone (no meta sidecar)."""
    return _write(path, state, config)


def load(path: str) -> Any:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def save_full(path: str, train_state: Dict, buffer: Dict, rng: Dict,
              config: Optional[Dict] = None, best: Optional[Dict] = None) -> str:
    """Format 2. ``buffer`` is ``ReplayBuffer.state_dict()``; ``best`` the
    gating best network, when there is one."""
    obj = {"train_state": train_state, "buffer": buffer, "rng": rng,
           "config": config, "format": FORMAT}
    if best is not None:
        obj["best"] = best
    path = _write(path, obj, config)
    meta = {"format": FORMAT,
            "buffer_capacity": int(buffer["value"].shape[0] - 1),
            "buffer_class": ("PrioritizedReplayBuffer" if "priority" in buffer
                             else "ReplayBuffer"),
            "num_actions": int(buffer["pi"].shape[-1]),
            "has_best": best is not None}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_meta(path: str) -> Dict:
    """The meta sidecar; ``{"format": 1}`` when there is none."""
    sidecar = os.path.abspath(path) + ".meta.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    return {"format": 1}


def load_full(path: str) -> Dict[str, Any]:
    """Format 2: the saved dict with ``"partial": False``. Format 1: only
    ``train_state``, with ``"partial": True``."""
    if load_meta(path).get("format", 1) >= 2:
        restored = load(path)
        restored["partial"] = False
        return restored
    return {"train_state": load(path), "partial": True}


def load_train_state(path: str) -> Dict:
    """The train state of either format."""
    return load_full(path)["train_state"]


def load_config(path: str) -> Optional[Dict]:
    sidecar = os.path.abspath(path) + ".config.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    return None


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Most recent ``checkpoint_*.pt`` or ``final_model.pt`` file."""
    if not os.path.isdir(checkpoint_dir):
        return None
    entries = [os.path.join(checkpoint_dir, e) for e in os.listdir(checkpoint_dir)
               if e.endswith(SUFFIX) and (e.startswith("checkpoint_")
                                          or e == "final_model" + SUFFIX)]
    if not entries:
        return None
    return max(entries, key=os.path.getmtime)
