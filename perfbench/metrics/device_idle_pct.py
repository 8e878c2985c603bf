"""The reader of `device_idle_pct` and of its splits by what they move (`device_idle_pct.eval`,
`device_idle_pct.stream`): `perfbench/spec.py` falls back to it by the name before
the split."""

from __future__ import annotations

from typing import Optional

from perfbench import trace


def read(ctx) -> Optional[float]:
    """Share of the traced window with no device activity."""
    w = trace.window_seconds(ctx.trace)
    return 100.0 * (1.0 - trace.busy_seconds(ctx.trace) / w) if w > 0 else None
