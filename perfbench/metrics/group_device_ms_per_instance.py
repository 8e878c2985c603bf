"""The reader of `group_device_ms_per_instance` and of its splits by what they move (`group_device_ms_per_instance.eval`,
`group_device_ms_per_instance.stream`): `perfbench/spec.py` falls back to it by the name before
the split."""

from __future__ import annotations

from typing import Optional

from perfbench import trace


def read(ctx) -> Optional[float]:
    """Device time of the group programs and of the singles' frontend and
    pose programs, per real instance."""
    s = trace.span_seconds(ctx.trace, "perfbench.group", "perfbench.single")
    return 1e3 * s / ctx.instances if ctx.instances and s > 0 else None
