"""The reader of `align_device_ms_per_instance` and of its splits by what they move
(`align_device_ms_per_instance.eval`, `align_device_ms_per_instance.stream`):
`perfbench/spec.py` falls back to it by the name before the split."""

from __future__ import annotations

from typing import Optional

from perfbench.metrics import _program


def read(ctx) -> Optional[float]:
    """Device time of the alignment stage (between the program's
    `stage_mark_align` and the next `stage_mark_end`) of the group programs
    and the singles' programs, per real instance."""
    return _program.stage_ms_per_instance(ctx, ("align",))
