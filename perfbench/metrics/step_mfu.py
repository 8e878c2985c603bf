"""The reader of `step_mfu` and of its splits by what they move (`step_mfu.eval`,
`step_mfu.stream`): `perfbench/spec.py` falls back to it by the name before
the split."""

from __future__ import annotations

from typing import Optional

from perfbench import flops, trace


def read(ctx) -> Optional[float]:
    """Model FLOPs of the instances posed in the traced window (the ViT-L
    forward over each instance's crop, both branch MLPs over its points and
    tuples) over the window at the bf16 peak, in percent."""
    w = trace.window_seconds(ctx.trace)
    return 100.0 * ctx.model_flops / (w * flops.PEAK_BF16_FLOPS) if w > 0 and ctx.model_flops else None
