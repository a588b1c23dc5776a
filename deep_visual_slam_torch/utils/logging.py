"""Metrics writer and step timer (port of ``utils/logging.py``).

``MetricsWriter`` always appends ``{"tag", "value", "step"}`` lines to
``<log_dir>/metrics.jsonl``; it also writes TensorBoard event files where
``tensorboardX`` can be imported, as the JAX package does, and only then
takes images (``takes_images``). A writer made with no ``log_dir`` (a
data-parallel trainer's ranks but the first) writes nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricsWriter:
    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._jsonl = self._tb = None
        if log_dir is None:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            SummaryWriter = None
        self._tb = SummaryWriter(log_dir) if SummaryWriter is not None else None

    def _open(self) -> bool:
        return self._jsonl is not None and not self._jsonl.closed

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self._open():
            return
        value = float(value)
        self._jsonl.write(json.dumps({"tag": tag, "value": value, "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    @property
    def takes_images(self) -> bool:
        """Whether :meth:`image` writes anywhere (a TensorBoard sink)."""
        return self._tb is not None

    def image(self, tag: str, image: np.ndarray, step: int) -> None:
        """An [H, W, 3] uint8 image, or float in [0, 1], to the TensorBoard
        sink; nothing without one."""
        if self._tb is None:
            return
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        self._tb.add_image(tag, img, step, dataformats="HWC")

    def scalars(self, values: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in values.items():
            self.scalar(prefix + k, float(v), step)

    def flush(self) -> None:
        if self._open():
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        if self._open():
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class StepTimer:
    """Rolling step time over the last ``window`` steps, and throughput."""

    window = 50

    def __init__(self):
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_step_time(self) -> float:
        return float(np.mean(self._times)) if self._times else 0.0

    def throughput(self, items_per_step: int) -> float:
        t = self.mean_step_time
        return items_per_step / t if t > 0 else 0.0
