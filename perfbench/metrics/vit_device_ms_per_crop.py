"""The reader of `vit_device_ms_per_crop` and of its splits by what they move (`vit_device_ms_per_crop.eval`,
`vit_device_ms_per_crop.stream`): `perfbench/spec.py` falls back to it by the name before
the split."""

from __future__ import annotations

from typing import Optional

from perfbench import trace


def read(ctx) -> Optional[float]:
    """Device time of the visual stages (the ViT-stage programs and the
    singles' visual stage) per crop they ran, padding included."""
    s = trace.span_seconds(ctx.trace, "perfbench.vit")
    return 1e3 * s / ctx.vit_crops if ctx.vit_crops and s > 0 else None
