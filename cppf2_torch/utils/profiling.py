"""Tracing and step timing.

Counterpart of `cppf2_tpu/utils/profiling.py`: `trace` records a
torch.profiler trace (CPU and, on a card, CUDA activity) into a directory
TensorBoard reads; `chained_timer` times one call on a chain of
data-dependent calls with a single device synchronization at its end
(PyTorch returns before the device finishes, so a host clock without it
would time the enqueue); `StepTimer` writes the JSONL step records of the
JAX package's, field for field.

The frame path's own instrumentation lives here too:

* `span(name)` times a piece of host work. It always adds to the open frame
  record's per-name count and nanoseconds (two `time.perf_counter_ns()`
  reads). While tracing is on it also keeps the interval, on the
  `time.time_ns()` clock that torch.profiler stamps its CPU events with, and
  opens `torch.profiler.record_function("cppf2.<name>")`, so that the span
  shows in any torch.profiler or TensorBoard trace beside the device work.
  Tracing is on while a torch profiler records, unless `tracing(True |
  False)` says otherwise; with it off a span never enters `record_function`.
* `frame_span(name)` is the root span of a frame: it opens a new frame
  record. `span(name, frame=id)` joins an earlier frame (a fetch joins the
  frame it fetches). A span opened outside any frame (a frame's draws, made
  before its dispatch) goes to the frame record that opens next.
* `count(name, n)` adds to a counter of the open frame record.
* `frames()` returns the last `FRAMES_KEPT` frame records (`FrameRecord`).
* `stage(name, device)` brackets one stage of the pose graph on the device:
  an empty one-thread marker kernel (`csrc/stage.cu`, `stage_mark_<name>`)
  is launched on the device's current stream when the stage begins, and
  `stage_mark_end` when it ends. Launched during a CUDA graph capture too, the
  markers replay with the graph at no host cost, and a trace attributes
  every kernel between a stage's marker and the next `stage_mark_end` to
  that stage. Stages do not nest; on the CPU nothing is launched, and
  `stage_log()` records the sequence of stage names for tests.

Spans, counters and stages are the process's, for a single host thread, as
the frame driver runs.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import json
import time
from typing import Callable, Dict, List, Optional

import torch

from cppf2_torch.ops import _build


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


# ---------------------------------------------------------------------------
# Host spans, counters and frame records
# ---------------------------------------------------------------------------

FRAMES_KEPT = 1024
_PENDING_INTERVALS = 1 << 16   # intervals kept for the next frame, past which they are dropped
_override: Optional[bool] = None
_stack: List[tuple] = []       # the open spans: (name, record, range or None, wall ns or None, perf ns)
_frames: "collections.deque" = collections.deque(maxlen=FRAMES_KEPT)
_ids = itertools.count(1)
_profiler_enabled = torch._C._autograd._profiler_enabled


class FrameRecord:
    """What one frame did on the host, from its `dispatch` span to its fetch.

    `id`; `start_ns`, `end_ns`: the `dispatch` span's start and end
    (`time.time_ns()`); `traced`: whether tracing was on when it opened;
    `spans`: {span name: [count, total ns]}; `intervals`: [(name, parent
    name or None, start ns, end ns)] of the spans opened while tracing was
    on (`time.time_ns()`); `counters`: {name: number} (`count`)."""

    __slots__ = ("id", "start_ns", "end_ns", "traced", "spans", "intervals", "counters")

    def __init__(self, fid: Optional[int], traced: bool):
        self.id, self.traced = fid, traced
        self.start_ns = self.end_ns = None
        self.spans: Dict[str, list] = {}
        self.intervals: List[tuple] = []
        self.counters: Dict[str, float] = {}

    def _take(self, other: "FrameRecord") -> None:
        """Add what `other` holds to this record."""
        for name, (n, ns) in other.spans.items():
            mine = self.spans.setdefault(name, [0, 0])
            mine[0] += n
            mine[1] += ns
        for name, v in other.counters.items():
            self.counters[name] = self.counters.get(name, 0) + v
        self.intervals.extend(other.intervals)


_pending = FrameRecord(None, False)   # what spans outside a frame hold for the next one


def tracing(on: Optional[bool]) -> Optional[bool]:
    """Turn tracing on (True) or off (False) whatever the profiler does, or
    let it follow the profiler (None, the default); returns the setting it
    replaces."""
    global _override
    prev, _override = _override, on
    return prev


def tracing_on() -> bool:
    """Whether spans keep intervals and open profiler ranges now."""
    return _profiler_enabled() if _override is None else _override


def frames() -> List[FrameRecord]:
    """The last `FRAMES_KEPT` frame records, oldest first."""
    return list(_frames)


def _record_of(fid: int) -> FrameRecord:
    for rec in reversed(_frames):
        if rec.id == fid:
            return rec
    return FrameRecord(fid, False)   # gone from the ring: counted nowhere


class _Span:
    """A span of one name (see `span`): it keeps no state of its own between
    enter and exit, so one object serves every use of its name."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self._push(_stack[-1][1] if _stack else _pending)

    def _push(self, rec: FrameRecord):
        rf = w0 = None
        if _profiler_enabled() if _override is None else _override:
            rf = torch.profiler.record_function("cppf2." + self.name)
            rf.__enter__()
            w0 = time.time_ns()
        _stack.append((self.name, rec, rf, w0, time.perf_counter_ns()))
        return rec.id

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        name, rec, rf, w0, t0 = _stack.pop()
        per = rec.spans.get(name)
        if per is None:
            rec.spans[name] = [1, t1 - t0]
        else:
            per[0] += 1
            per[1] += t1 - t0
        if rf is not None:
            w1 = time.time_ns()
            rf.__exit__(None, None, None)
            if rec is not _pending or len(rec.intervals) < _PENDING_INTERVALS:
                rec.intervals.append((name, _stack[-1][0] if _stack else None, w0, w1))
        return False


class _Join(_Span):
    """A span that counts in the frame record of id `frame`."""

    __slots__ = ("frame",)

    def __init__(self, name: str, frame: int):
        self.name, self.frame = name, frame

    def __enter__(self):
        return self._push(_record_of(self.frame))


_spans: Dict[str, _Span] = {}


def span(name: str, frame: Optional[int] = None) -> _Span:
    """`with span(name):` times the block into the open frame record (see
    the module's docstring); `frame=` a frame id joins that frame instead.
    Entering returns the id of the record it counts in (None outside a
    frame)."""
    if frame is not None:
        return _Join(name, frame)
    s = _spans.get(name)
    if s is None:
        s = _spans[name] = _Span(name)
    return s


class frame_span(_Span):
    """The root span of a new frame: opens a frame record, which takes what
    spans outside any frame left for it (`with frame_span("dispatch") as
    fid:`)."""

    __slots__ = ()

    def __enter__(self):
        global _pending
        rec = FrameRecord(next(_ids), tracing_on())
        rec._take(_pending)
        _pending = FrameRecord(None, False)
        _frames.append(rec)
        rec.start_ns = time.time_ns()
        return self._push(rec)

    def __exit__(self, exc_type, exc, tb):
        rec = _stack[-1][1]
        super().__exit__(exc_type, exc, tb)
        rec.end_ns = time.time_ns()
        return False


def count(name: str, n: float = 1) -> None:
    """Add `n` to counter `name` of the open frame record."""
    c = (_stack[-1][1] if _stack else _pending).counters
    c[name] = c.get(name, 0) + n


# ---------------------------------------------------------------------------
# Device stage markers
# ---------------------------------------------------------------------------

# the marker kernels' order in `csrc/stage.cu`; `stage_mark_end` follows them
STAGES = ("frontend", "descriptors", "mlps", "targets", "center_vote", "backvote", "cone_vote",
          "align", "finish", "vit")
_END = len(STAGES)
_stage_open: Optional[str] = None
_stage_logs: List[List[str]] = []


@contextlib.contextmanager
def stage_log():
    """The names of the stages entered inside, in order."""
    log: List[str] = []
    _stage_logs.append(log)
    try:
        yield log
    finally:
        _stage_logs.remove(log)


def _mark(which: int, dev: torch.device) -> None:
    """Launch marker kernel `which` (its index in `STAGES`, or `_END`) on
    `dev`'s current stream."""
    _build.launch("stage", "cppf2_stage_mark", [ctypes.c_int, ctypes.c_void_p], dev, which)


class stage:
    """`with stage(name, device):` brackets one stage of the pose graph with
    its marker kernels on `device` (none on the CPU). A stage opened inside
    another raises."""

    __slots__ = ("name", "which", "cuda", "dev")

    def __init__(self, name: str, device):
        self.name, self.which = name, STAGES.index(name)
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"

    def __enter__(self):
        global _stage_open
        if _stage_open is not None:
            raise RuntimeError(f"stage {self.name!r} opened inside stage {_stage_open!r}: "
                               f"stages do not nest")
        if self.cuda:
            _mark(self.which, self.dev)
        _stage_open = self.name
        for log in _stage_logs:
            log.append(self.name)
        return self

    def __exit__(self, exc_type, *exc):
        global _stage_open
        _stage_open = None
        if self.cuda and exc_type is None:
            _mark(_END, self.dev)
        return False
