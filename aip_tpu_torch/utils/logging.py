"""Training observability: scalar logging to JSONL and, where the
``tensorboard`` package is installed, TensorBoard event files. Port of
``aip_tpu.utils.logging``.

Replaces the reference's TensorBoard usage (``train.py:34-39,324-330,
345-415`` training_report; TensorboardX in ``AdaIN/train.py``). JSONL is
the primary sink (greppable, no dependencies); the writer
(``torch.utils.tensorboard.SummaryWriter``) is attached when it imports.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class ScalarLogger:
    def __init__(self, log_dir, use_tensorboard: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "scalars.jsonl", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.log_dir / "tb"))
            except Exception:
                self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step), "t": time.time()}
        ) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
