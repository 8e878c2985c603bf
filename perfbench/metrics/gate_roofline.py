"""The reader of `gate_roofline` and of its splits by what they move
(`gate_roofline.vitg`): `perfbench/spec.py` falls back to it by the name
before the split.

K5, the SwiGLU gate (`cppf2_torch/csrc/swiglu.cu`, kernels named
`swiglu_gate_kernel`), reads each bfloat16 element of a and b once and
writes each product once: `GATE_BYTES` an element, at the HBM's peak its
least time. The elements come from the program's frame records (the
`gate_elems` counter of the traced frames, which the driver counts where it
dispatches a visual stage); a program without them, or a trace without the
kernel, gives None.
"""

from __future__ import annotations

from typing import Optional

from perfbench import flops, trace
from perfbench.metrics import _program

GATE_BYTES = 6   # a and b read, the product written: two bytes each in bfloat16
KERNEL = "swiglu_gate"


def read(ctx) -> Optional[float]:
    """K5's least time (`GATE_BYTES` x the traced frames' gate elements over
    the HBM's peak) over its measured device time, in percent."""
    t, n = trace.kernel_seconds(ctx.trace, KERNEL)
    if not n or t <= 0:
        return None
    got = _program.traced_frames(ctx)
    if got is None:
        return None
    elems = sum(r.counters.get("gate_elems", 0) for r in got[0])
    return 100.0 * GATE_BYTES * elems / flops.PEAK_HBM_BYTES / t if elems else None
