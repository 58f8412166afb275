"""Training metrics writer.

Port of ``othello_reinforcement_learning_test_tpu/utils/metrics.py``. The
contract is the JSONL stream ``<log_dir>/metrics.jsonl``: one
``{"tag", "value", "step", "ts"}`` object per scalar. TensorBoard event
files are written beside it only when ``torch.utils.tensorboard`` can be
imported.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:  # tensorboard is optional
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                      "ts": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
