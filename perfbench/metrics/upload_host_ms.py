"""The reader of `upload_host_ms` and of its splits by what they move (`upload_host_ms.eval`,
`upload_host_ms.stream`): `perfbench/spec.py` falls back to it by the name before the
split."""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import Optional

from perfbench.metrics import _program


def read(ctx) -> Optional[float]:
    """Host ms a frame inside the program's `upload` spans (host arrays made
    device tensors), from the frame records of the traced run's untraced
    pass. Prints every span's count and host ms a frame, and the counters."""
    host = _program.host_pass(ctx)
    if host is None:
        return None
    n = len(host)
    spans, counters = defaultdict(lambda: [0, 0]), defaultdict(float)
    for r in host:
        for name, (k, ns) in r.spans.items():
            spans[name][0] += k
            spans[name][1] += ns
        for name, v in r.counters.items():
            counters[name] += v
    order = sorted(spans.items(), key=lambda kv: -kv[1][1])
    print("[perfbench] host a frame by program span (count, ms), untraced pass: "
          + ", ".join(f"{k} {v[0] / n:.2f} {v[1] / 1e6 / n:.3f}" for k, v in order)
          + "; counters a frame: " + ", ".join(f"{k} {v / n:.4g}" for k, v in sorted(counters.items())),
          file=sys.stderr)
    return spans["upload"][1] / 1e6 / n
