"""Metrics writer (the port's own copy of lunaris_orion_tpu/utils/metrics.py).

Always appends one JSON line a call to `metrics.jsonl`; also writes
TensorBoard scalars under <prefix>/<name> when `torch.utils.tensorboard`
imports (the reference logs its train/* scalars there,
train_hybrid.py:621-624, 929-946).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(str(self.log_dir))
        except ImportError:
            pass
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")

    def log(self, metrics: Dict[str, float], step: int,
            prefix: str = "train") -> None:
        """Values may be 0-d device tensors: float() reads each one, so a
        call waits for the device."""
        clean = {k: float(v) for k, v in metrics.items()}
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)
        self._jsonl.write(json.dumps(
            {"step": step, "time": time.time(), "prefix": prefix, **clean}) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
