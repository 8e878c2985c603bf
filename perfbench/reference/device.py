"""Device constants of the reference (a frozen copy of
`cppf2_torch/device.py::device_constant`)."""

from __future__ import annotations

from typing import Callable, Dict

import torch


_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def device_constant(key, make: Callable[[], torch.Tensor], device) -> torch.Tensor:
    """`make()`, a tensor built from host values, on `device`: built once per
    (key, device) and the same tensor on every later call.

    On a CUDA device a tensor built from host values is a pageable
    host-to-device copy, which blocks the host and cannot be recorded into a
    CUDA graph. A constant built once, before a program's capture (its
    warm-up builds it), is only read inside the capture. The caller must not
    write into the tensor it gets."""
    dev = torch.device(device)
    k = (key, dev.type, dev.index)
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS[k] = make().to(dev)
    return t
