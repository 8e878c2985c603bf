"""The reference's precision, and the control's one step below it.

The reference computes in float32 with TF32 off. The control (`lower`) is
the reference put in the program's place one step below what the
configuration states: every linear and the attention of layers the
configuration runs in bfloat16 (the ViT, the branch MLPs) see their operands
rounded to float8 e4m3 with a scale per row, and the float32 pose graph's
matrix products run in TF32.
"""

from __future__ import annotations

import contextlib

import torch

LOWER = False
_E4M3_MAX = 448.0


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """`x` (float32) rounded to float8 e4m3 with one scale per row (its last
    axis), back in float32."""
    scale = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True), min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def low(x: torch.Tensor) -> torch.Tensor:
    """An operand of a bfloat16 layer: as it is, or in the control fp8-rounded."""
    return fp8_rows(x.float()) if LOWER else x


@contextlib.contextmanager
def lower():
    """Compute the reference one precision step below the configuration."""
    global LOWER
    saved = (LOWER, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    LOWER = True
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        LOWER = saved[0]
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[1], saved[2]


def exact() -> None:
    """True float32 products: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
