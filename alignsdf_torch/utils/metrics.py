"""Training metrics sink, JSONL (the JAX package's ``utils/metrics.py``
without TensorBoard): one object per logged step with the loss values, and
one per epoch with the learning rate and the epoch's time, appended to
``<experiment>/metrics.jsonl`` (reference train.py:400-402,600-623,632-633
logs the same quantities to TensorBoard).
"""

from __future__ import annotations

import json
import os
from typing import Dict


class MetricsLogger:
    def __init__(self, experiment_dir: str):
        self.jsonl_path = os.path.join(experiment_dir, "metrics.jsonl")

    def _write(self, record: Dict) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_step(self, epoch: int, step: int, losses: Dict[str, float]) -> None:
        self._write({"epoch": epoch, "step": step, **losses})

    def log_epoch(self, epoch: int, lr: float, epoch_time_s: float) -> None:
        self._write({"epoch": epoch, "lr": lr, "epoch_time_s": round(epoch_time_s, 2)})
