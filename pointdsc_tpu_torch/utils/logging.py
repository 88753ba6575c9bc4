"""Metrics logging (the port's copy of ``pointdsc_tpu/utils/logging.py``): a
JSONL event stream in the log directory, which is the durable record, and a
TensorBoard writer beside it when ``tensorboardX`` is installed."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "events.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # type: ignore
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(log_dir=log_dir)

    def log_scalar(self, tag: str, value: float, step: int):
        self._f.write(
            json.dumps({"t": time.time(), "tag": tag, "value": value, "step": step}) + "\n")
        self._f.flush()
        if self._tb:
            self._tb.add_scalar(tag, value, step)

    def log_dict(self, prefix: str, metrics: dict, step: int):
        for k, v in metrics.items():
            self.log_scalar(f"{prefix}/{k}", float(v), step)

    def close(self):
        self._f.close()
        if self._tb:
            self._tb.close()
