"""The reader of `dispatch_idle_ms` and of its splits by what they move
(`dispatch_idle_ms.eval`, `dispatch_idle_ms.stream`): `perfbench/spec.py` falls back
to it by the name before the split."""

from __future__ import annotations

import sys
from typing import Optional

from perfbench import trace
from perfbench.metrics import _program

_NOT_DISPATCH = ("outside", "fetch")


def read(ctx) -> Optional[float]:
    """Device idle ms a traced frame in the gaps that begin while the host
    is in a program span of the dispatch side (`draws`, `dispatch` and the
    spans inside it), by the program's frame records aligned to the trace.
    Prints the split by span once."""
    got = _program.traced_frames(ctx)
    if got is None:
        return None
    recs, offset = got
    by = _program.idle_by_span(ctx, recs, offset)
    idle = trace.window_seconds(ctx.trace) - trace.busy_seconds(ctx.trace)
    n = ctx.frames
    print(f"[perfbench] device idle a traced frame by the host's program span (ms, of it in gaps "
          f"of 0.05 ms or more), {sum(v[0] for v in by.values()):.3f} of {1e3 * idle:.3f} ms idle "
          f"in all, clock offset {offset:.1f} us: " + ", ".join(
              f"{k} {v[0] / n:.3f} ({v[1] / n:.3f})"
              for k, v in sorted(by.items(), key=lambda kv: -kv[1][0])), file=sys.stderr)
    return sum(v[0] for k, v in by.items() if k not in _NOT_DISPATCH) / n
