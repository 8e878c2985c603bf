"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Callable, Dict

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return `device` as a torch.device, ready for the port's numerics.

    CUDA is the default and is never silently replaced by the CPU: asking for
    it without a card raises. On CUDA, TF32 is switched off for matmuls and
    convolutions: the 1-degree sphere threshold cos(2 deg) ~ 0.9994 and the
    kNN distances need true float32 products.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


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
