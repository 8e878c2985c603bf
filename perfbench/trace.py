"""Reading a traced window: torch.profiler's chrome trace -> device intervals
credited to the benchmark's spans.

The harness opens `perfbench.<layer>` ranges (`torch.profiler.
record_function`) around its calls into each layer, and one
`perfbench.window` range around the whole traced window. Every device
activity (kernel, memcpy, memset) carries the correlation id of the runtime
or driver call that launched it; a kernel of a captured CUDA graph carries
the id of its `cudaGraphLaunch`. A device activity is credited to the
innermost benchmark range, on the launching thread, that encloses its launch
call.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")
PREFIX = "perfbench."
WINDOW = PREFIX + "window"


class Activity(NamedTuple):
    name: str
    start: float    # microseconds, trace clock
    end: float
    span: Optional[str]


class Trace(NamedTuple):
    window: Tuple[float, float]          # microseconds
    activities: List[Activity]
    host: List[Tuple[float, float, str]]  # benchmark ranges on the host (start, end, name)
    credited_share: float                 # device time credited to a span, of all in the window


def _innermost(ranges, tid, t):
    """The innermost range of thread `tid` that encloses time `t`, or None."""
    best = None
    for start, end, name in ranges.get(tid, ()):
        if start > t:
            break
        if end >= t and (best is None or start >= best[0]):
            best = (start, end, name)
    return None if best is None else best[2]


def parse(events: List[Dict]) -> Trace:
    ranges: Dict = defaultdict(list)
    window = None
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        name = e.get("name", "")
        if not name.startswith(PREFIX):
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if name == WINDOW:
            window = (start, end)
        else:
            ranges[e.get("tid")].append((start, end, name))
    if window is None:
        raise ValueError("the trace holds no perfbench.window range")
    for v in ranges.values():
        v.sort()
    span_of: Dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _LAUNCH:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                span_of[corr] = _innermost(ranges, e.get("tid"), float(e["ts"]))
    acts = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE:
            continue
        start = float(e["ts"])
        end = start + float(e.get("dur", 0))
        if end <= window[0] or start >= window[1]:
            continue
        corr = (e.get("args") or {}).get("correlation")
        acts.append(Activity(e.get("name", ""), start, end, span_of.get(corr)))
    acts.sort(key=lambda a: a.start)
    total = sum(a.end - a.start for a in acts)
    credited = sum(a.end - a.start for a in acts if a.span is not None)
    host = sorted(r for v in ranges.values() for r in v)
    return Trace(window, acts, host, credited / total if total else 0.0)


def load(path: str) -> Trace:
    with open(path) as f:
        return parse(json.load(f)["traceEvents"])


def busy_intervals(tr: Trace) -> List[Tuple[float, float]]:
    """The union of device activity, clipped to the window, as sorted disjoint
    intervals."""
    lo, hi = tr.window
    out: List[List[float]] = []
    for a in tr.activities:
        s, e = max(a.start, lo), min(a.end, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(tr: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(tr)) / 1e6


def window_seconds(tr: Trace) -> float:
    return (tr.window[1] - tr.window[0]) / 1e6


def span_seconds(tr: Trace, *spans: str) -> float:
    """Device time of the activities credited to any of `spans`."""
    return sum(a.end - a.start for a in tr.activities if a.span in spans) / 1e6


def kernel_seconds(tr: Trace, fragment: str) -> Tuple[float, int]:
    """Device time and count of the kernels whose name holds `fragment`."""
    hits = [a for a in tr.activities if fragment in a.name]
    return sum(a.end - a.start for a in hits) / 1e6, len(hits)


def top_ops(tr: Trace, n: int = 10) -> List[List]:
    by = defaultdict(float)
    for a in tr.activities:
        by[a.name] += (a.end - a.start) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace, n: int = 10) -> List[List]:
    """The longest gaps of the window with no device activity, each named by
    the innermost benchmark range the host was in when it began."""
    busy = busy_intervals(tr)
    lo, hi = tr.window
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    starts = [r[0] for r in tr.host]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        name = "host: outside the benchmark's ranges"
        i = bisect.bisect_right(starts, s)
        best = None
        for r in tr.host[:i]:
            if r[1] >= s and (best is None or r[0] >= best[0]):
                best = r
        if best is not None:
            name = "host: " + best[2]
        out.append([name, (e - s) / 1e6])
    return out
