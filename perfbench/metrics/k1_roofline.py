"""The reader of `k1_roofline` and of its splits by what they move (`k1_roofline.eval`,
`k1_roofline.stream`): `perfbench/spec.py` falls back to it by the name before
the split."""

from __future__ import annotations

from typing import Optional

from perfbench import trace


def read(ctx) -> Optional[float]:
    """The attention calls' least time from their shapes over K1's measured
    device time, in percent."""
    t, n = trace.kernel_seconds(ctx.trace, "mha_fwd_kernel")
    return 100.0 * ctx.k1_bound_s / t if n and t > 0 else None
