"""The reader of `dispatch_host_ms` and of its splits by what they move (`dispatch_host_ms.eval`,
`dispatch_host_ms.stream`): `perfbench/spec.py` falls back to it by the name before
the split."""

from __future__ import annotations

from typing import Optional


def read(ctx) -> Optional[float]:
    """Host time of one frame's draws and `dispatch_frame` call (the draws are
    made inside it when `evaluate_real275` calls it), averaged over the
    untraced pass of the traced run."""
    return sum(ctx.dispatch_ms) / len(ctx.dispatch_ms) if ctx.dispatch_ms else None
