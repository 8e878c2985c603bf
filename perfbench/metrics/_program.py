"""What the program's own instrumentation gives the traced run's readers.

* Stage markers: `cppf2_torch/utils/profiling.py::stage` launches an empty
  kernel `stage_mark_<stage>` where a stage of a captured program begins and
  `stage_mark_end` where it ends, so a replay's kernels, which all carry the
  correlation id of one graph launch, can be told apart by stage. `split`
  walks the traced window's device activities in order and gives each one
  credited to the benchmark's `perfbench.group` or `perfbench.single` range
  to the stage whose markers enclose it (a marker to the stage it opens or
  closes).
* Frame records: `profiling.frames()` holds each frame's host spans and
  counters, and, for the frames dispatched while the profiler recorded, the
  spans' intervals on `time.time_ns()`'s clock. `traced_frames` aligns them
  to the trace's clock through the harness's `perfbench.dispatch` ranges.

A program without the markers or the records (a commit before them) gives
None, and so does a trace whose markers do not alternate begin / end. A
trace whose device clock drifts from the host's (rarely, by milliseconds)
loses the activities it places past the window's edge, and with them a
stage's first or last marker: a marker out of turn is repaired where the
others alternate (see `split`).
Each split is printed once a run, to standard error, with its repairs.
"""

from __future__ import annotations

import bisect
import statistics
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench import trace

MARK = "stage_mark_"
END = "end"
# the stages of a group replay and of a single's frontend and pose programs
POSE_STAGES = ("frontend", "descriptors", "mlps", "targets", "center_vote", "backvote",
               "cone_vote", "align", "finish")
POSE_SPANS = ("perfbench.group", "perfbench.single")
SLACK_US = 50.0     # how far an aligned program span may lie outside its harness range
REPAIRED_SHARE = 0.05   # of the markers, how many may be out of turn and repaired
_printed = set()


def _stage_of(name: str) -> Optional[str]:
    if not name.startswith(MARK):
        return None
    return name[len(MARK):].split("(")[0]


def split(tr: trace.Trace) -> Tuple[Optional[Dict], Optional[str]]:
    """({stage: {kernel name: device seconds}} of the activities credited to
    `POSE_SPANS`, the key None holding those outside any stage, and None, or
    what was repaired); or (None, why) without markers, or where they do not
    alternate begin / end.

    A marker out of turn is one whose partner the trace lost (at the
    window's edge) or misplaced: a begin inside a stage closes that stage
    and opens its own, an end outside a stage is passed over, a stage open
    at the trace's end closes there. Up to `REPAIRED_SHARE` of the markers
    are repaired so, each moving at most one stage's work of one replay;
    past it, None."""
    cur, marks, faults = None, 0, []
    by: Dict = defaultdict(lambda: defaultdict(float))
    # of two that start together, the shorter first: an empty marker can end where it starts
    acts = sorted(tr.activities, key=lambda a: (a.start, a.end))
    for i, a in enumerate(acts):
        stage = _stage_of(a.name)
        if stage is not None:
            marks += 1
            if (stage == END) == (cur is None):
                near = "; ".join(f"{b.name[:40]} {b.start:.1f}-{b.end:.1f} {b.span}"
                                 for b in acts[max(0, i - 4):i + 2])
                faults.append(f"{a.name} at {a.start:.1f} us in stage {cur}: {near}")
            if stage != END:
                cur = stage
        if a.span in POSE_SPANS:
            by[cur][a.name] += (a.end - a.start) / 1e6
        if stage == END:
            cur = None
    if not marks:
        return None, "no stage markers"
    if cur is not None:
        faults.append(f"stage {cur} never ends")
    if not faults:
        return by, None
    what = f"{len(faults)} of {marks} markers out of turn; the first: {faults[0]}"
    return (None, what) if len(faults) > REPAIRED_SHARE * marks else (by, "repaired " + what)


def stage_ms_per_instance(ctx, stages) -> Optional[float]:
    """Device ms per instance of `stages`, printing the whole split once."""
    by, why = split(ctx.trace)
    if ("split", id(ctx.trace)) not in _printed:
        _printed.add(("split", id(ctx.trace)))
        if by is None:
            print(f"[perfbench] no stage split: {why}", file=sys.stderr)
        else:
            if why:
                print(f"[perfbench] stage split {why}", file=sys.stderr)
            if ctx.instances:
                _print_split(ctx, by)
    if by is None or not ctx.instances:
        return None
    s = sum(sum(by[st].values()) for st in stages if st in by)
    return 1e3 * s / ctx.instances if s > 0 else None


def _print_split(ctx, by) -> None:
    n = ctx.instances
    pose = trace.span_seconds(ctx.trace, *POSE_SPANS)
    marks = sum(v for kernels in by.values() for k, v in kernels.items() if k.startswith(MARK))
    total = sum(sum(k.values()) for k in by.values())
    lines = []
    for st in (*POSE_STAGES, None):
        kernels = sorted(by.get(st, {}).items(), key=lambda kv: -kv[1])
        shown = kernels if st is None else kernels[:1]   # outside a stage: every activity
        lines.append(f"  {st or 'outside any stage'}: {1e3 * sum(v for _, v in kernels) / n:.4f} "
                     f"ms an instance; " + "; ".join(f"{k[:72]} {1e3 * v / n:.4f}" for k, v in shown))
    print(f"[perfbench] a group replay by stage ({n} instances; stages and copies "
          f"{1e3 * total / n:.4f} ms an instance against {1e3 * pose / n:.4f} credited to "
          f"{'/'.join(POSE_SPANS)}; markers {1e6 * marks / n:.2f} us an instance, "
          f"{100 * marks / pose if pose else 0:.4f}%):\n" + "\n".join(lines), file=sys.stderr)


def frame_records():
    """The program's frame records, or None where it keeps none."""
    try:
        from cppf2_torch.utils import profiling
    except ImportError:
        return None
    frames = getattr(profiling, "frames", None)
    return None if frames is None else frames()


def host_pass(ctx) -> Optional[List]:
    """The untraced host pass's frame records: the `ctx.host_frames` records
    just before the first traced one."""
    recs = frame_records()
    if not recs or not ctx.host_frames:
        return None
    first = next((i for i, r in enumerate(recs) if r.traced), None)
    if first is None or first < ctx.host_frames:
        return None
    host = recs[first - ctx.host_frames:first]
    return None if any(r.traced for r in host) else host


def traced_frames(ctx) -> Optional[Tuple[List, float]]:
    """(the traced window's frame records, the offset in microseconds that
    takes a record's `time.time_ns()` / 1e3 to the trace's clock): the
    median gap between each harness `perfbench.dispatch` range's start and
    its frame's `dispatch` span's. None where the counts differ or an
    aligned `dispatch` span lies more than `SLACK_US` outside its range."""
    recs = frame_records()
    if not recs:
        return None
    recs = [r for r in recs if r.traced][-ctx.frames:]
    ranges = sorted(h for h in ctx.trace.host if h[2] == trace.PREFIX + "dispatch")
    if len(recs) != ctx.frames or len(ranges) != len(recs) or not recs:
        return None
    offset = statistics.median(h[0] - r.start_ns / 1e3 for h, r in zip(ranges, recs))
    for h, r in zip(ranges, recs):
        if r.start_ns / 1e3 + offset < h[0] - SLACK_US or r.end_ns / 1e3 + offset > h[1] + SLACK_US:
            return None
    return recs, offset


def idle_by_span(ctx, recs, offset: float) -> Dict[str, List[float]]:
    """{name: [idle ms, of it in gaps of 0.05 ms or more]} over the window's
    idle gaps, each named by the innermost program span the host was in at
    its start (`fetch` kept apart, as it is not dispatch), or "outside"."""
    spans = sorted(((s / 1e3 + offset, e / 1e3 + offset, name, parent)
                    for r in recs for name, parent, s, e in r.intervals),
                   key=lambda sp: (sp[0], -sp[1]))   # of two that start together, the outer first
    roots = [sp for sp in spans if sp[3] is None]
    root_starts = [sp[0] for sp in roots]
    starts = [sp[0] for sp in spans]
    busy = trace.busy_intervals(ctx.trace)
    lo, hi = ctx.trace.window
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
    for i in range(0, len(edges) - 1, 2):
        s, e = edges[i], edges[i + 1]
        if e <= s:
            continue
        name = "outside"
        j = bisect.bisect_right(root_starts, s) - 1
        if j >= 0 and roots[j][1] >= s:
            k = bisect.bisect_right(starts, s) - 1
            while k >= 0 and spans[k][0] >= roots[j][0]:
                if spans[k][1] >= s:
                    name = spans[k][2]
                    break
                k -= 1
        out[name][0] += (e - s) / 1e3
        if e - s >= 50.0:
            out[name][1] += (e - s) / 1e3
    return out

