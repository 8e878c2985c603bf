"""The reader of `replays_per_frame` and of its splits by what they move (`replays_per_frame.eval`,
`replays_per_frame.stream`): `perfbench/spec.py` falls back to it by the name before
the split."""

from __future__ import annotations

from typing import Optional


def read(ctx) -> Optional[float]:
    """Program replays per frame (`programs.recorded()`'s census) of the
    untraced pass."""
    return ctx.replays / ctx.host_frames if ctx.host_frames else None
