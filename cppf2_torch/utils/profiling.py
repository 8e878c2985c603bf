"""Tracing and step timing.

Counterpart of `cppf2_tpu/utils/profiling.py`: `trace` records a
torch.profiler trace (CPU and, on a card, CUDA activity) into a directory
TensorBoard reads; `chained_timer` times one call on a chain of
data-dependent calls with a single device synchronization at its end
(PyTorch returns before the device finishes, so a host clock without it
would time the enqueue); `StepTimer` writes the JSONL step records of the
JAX package's, field for field.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Callable, Dict, Optional

import torch


def _sync() -> None:
    """Wait for the device's queued work (nothing to wait for without a card)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace of the block into `log_dir` (view with
    TensorBoard's profiler plugin)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def chained_timer(fn: Callable, chain: Callable, args0, iters: int = 24, warmup: int = 4) -> float:
    """Milliseconds per call of `fn`, measured on a dependency chain.

    Args:
        fn: callable taking `args0`-like inputs, returning outputs.
        chain: (args, outputs) -> next args, so that each call depends on
            the one before.
        args0: initial inputs (tuple).
    """
    fn(*args0)
    _sync()
    args = args0
    for _ in range(warmup):
        out = fn(*args)
        args = chain(args, out)
    _sync()
    t0 = time.perf_counter()
    args = args0
    for _ in range(iters):
        out = fn(*args)
        args = chain(args, out)
    _sync()
    return (time.perf_counter() - t0) / iters * 1000.0


class StepTimer:
    """Step timer with an exponential moving average, writing one JSON line
    per step: {"step", "step_ms", "avg_ms", **extra}."""

    def __init__(self, path: Optional[str] = None, ema: float = 0.98):
        self.path = path
        self.ema = ema
        self._avg = None
        self._last = time.time()

    def tick(self, step: int, extra: Optional[Dict] = None) -> Dict:
        now = time.time()
        dt = now - self._last
        self._last = now
        self._avg = dt if self._avg is None else self.ema * self._avg + (1 - self.ema) * dt
        rec = {"step": step, "step_ms": dt * 1000, "avg_ms": self._avg * 1000}
        if extra:
            rec.update(extra)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec
