"""Metrics writer, step timer and the program's spans (port of
``utils/logging.py``; the spans are the port's own).

``MetricsWriter`` always appends ``{"tag", "value", "step"}`` lines to
``<log_dir>/metrics.jsonl``; it also writes TensorBoard event files where
``tensorboardX`` can be imported, as the JAX package does, and only then
takes images (``takes_images``). A writer made with no ``log_dir`` (a
data-parallel trainer's ranks but the first) writes nothing.

Spans name stretches of the host's work inside the train steps
(``training/steps.py``, ``vo_learner.py``, ``depth_learner.py``): ``step``,
``step.input``, ``net.depth.fwd``, ``net.pose.fwd``, ``loss.warp``,
``loss.photometric``, ``loss.depth``, ``loss.bwd``, ``net.bwd``,
``optimizer``. Tracing is on while :func:`enable` has turned it on, and
while a ``torch.profiler`` records (the flag that torch keeps for such
checks), so that any profiler's trace shows the spans; otherwise it is off.
On, each span records its start and length on the realtime clock
(``time.time_ns``, the clock of a ``torch.profiler`` chrome trace) and its
depth among the open spans into one bounded buffer for the process, which
:func:`drain` empties, and opens a ``record_function`` range of its name.
Nothing here synchronises with the device.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _profiler


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
    """Steps a second between synchronised readbacks. A trainer calls
    :meth:`mark` right after it reads a loss back to the host (``.item()``
    waits for every step launched so far) with the number of steps done;
    :meth:`throughput` is then the samples of the steps between the last
    two marks over the host seconds between them, 0 before a second mark.
    :meth:`restart` forgets the last mark, so that time spent between
    epochs (validation, checkpoints) is not counted."""

    def __init__(self):
        self._last: Optional[Tuple[float, int]] = None
        self._step_s = 0.0

    def restart(self) -> None:
        self._last = None

    def mark(self, steps_done: int) -> None:
        now = time.perf_counter()
        if self._last is not None and steps_done > self._last[1]:
            self._step_s = (now - self._last[0]) / (steps_done - self._last[1])
        self._last = (now, steps_done)

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self._step_s if self._step_s > 0 else 0.0


# --- the program's spans ----------------------------------------------------

SPAN_CAPACITY = 1 << 16  # spans the buffer holds; past it the oldest go

_on = False
_lock = threading.RLock()
_buffer: deque = deque(maxlen=SPAN_CAPACITY)
_depth = 0  # spans open now, over every thread
_split: Optional["_Split"] = None  # the split span waiting for a gradient
_NOOP = contextlib.nullcontext()


def enable() -> None:
    """Turns tracing on: spans record from the next one opened, with or
    without a profiler."""
    global _on
    _on = True


def disable() -> None:
    """Turns :func:`enable`'s tracing off (a running profiler keeps it on);
    what was recorded stays until :func:`drain`."""
    global _on
    _on = False


def drain() -> List[Tuple[str, float, float, int]]:
    """The recorded spans, ``(name, start_us, dur_us, depth)`` in the order
    they closed, with the buffer emptied. ``start_us`` is on the realtime
    clock; ``depth`` counts the spans open when it opened."""
    with _lock:
        spans = list(_buffer)
        _buffer.clear()
    return spans


class _Span:
    """One span: opened by ``__enter__`` (or :meth:`open`), closed by
    ``__exit__`` (or :meth:`close`), from any thread."""

    __slots__ = ("name", "start_ns", "depth", "_range")

    def __init__(self, name: str):
        self.name = name

    def open(self) -> "_Span":
        global _depth
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        with _lock:
            self.depth = _depth
            _depth += 1
        self.start_ns = time.time_ns()
        return self

    def close(self) -> None:
        global _depth
        end_ns = time.time_ns()
        self._range.__exit__(None, None, None)
        with _lock:
            _depth -= 1
            _buffer.append((self.name, self.start_ns / 1e3, (end_ns - self.start_ns) / 1e3,
                            self.depth))

    __enter__ = open

    def __exit__(self, *exc) -> None:
        self.close()


def span(name: str):
    """A context manager that records the span ``name`` while tracing is
    on; while it is off, one shared context that does nothing, after two
    flag checks."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name)


class _Split:
    """Span ``first`` from entry until a gradient reaches a tensor that
    :func:`watch_gradients` hooked, then span ``second`` until exit."""

    def __init__(self, first: str, second: str):
        self.second = second
        self.current = _Span(first)

    def __enter__(self) -> "_Split":
        global _split
        self.current.open()
        with _lock:
            _split = self
        return self

    def switch(self) -> None:
        with _lock:
            if self.current.name == self.second:
                return
            self.current.close()
            self.current = _Span(self.second).open()

    def __exit__(self, *exc) -> None:
        global _split
        with _lock:
            _split = None
            self.current.close()


def split_span(first: str, second: str):
    """A context manager over a backward pass: span ``first`` until the
    first gradient reaches a watched tensor (:func:`watch_gradients`), on
    whichever thread autograd runs it, then span ``second``. Autograd runs
    nodes of higher sequence numbers first, so the loss's backward, made
    after the networks' forward, runs as one block before the networks'
    own. While tracing is off, the shared context that does nothing."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NOOP
    return _Split(first, second)


def _gradient_arrived(grad: torch.Tensor) -> None:
    split = _split
    if split is not None:
        split.switch()


def watch_gradients(tensors: Iterable) -> None:
    """While tracing is on, hooks each tensor of ``tensors`` that requires
    grad, for :func:`split_span`; the hooks return None, so no gradient
    changes. While it is off, registers nothing."""
    if not (_on or _profiler._is_profiler_enabled):
        return
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            t.register_hook(_gradient_arrived)
