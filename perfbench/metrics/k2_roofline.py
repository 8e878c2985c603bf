"""The reader of `k2_roofline` and of its splits by what they move (`k2_roofline.eval`,
`k2_roofline.stream`): `perfbench/spec.py` falls back to it by the name before
the split."""

from __future__ import annotations

from typing import Optional

from perfbench import trace


def read(ctx) -> Optional[float]:
    """The vote levels' least time from their shapes over K2's measured device
    time, in percent."""
    t, n = trace.kernel_seconds(ctx.trace, "hist16_kernel")
    return 100.0 * ctx.k2_bound_s / t if n and t > 0 else None
