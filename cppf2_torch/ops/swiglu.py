"""Kernel K5: the SwiGLU gate of a DINOv2 ViT-g block.

Replaces no TPU kernel: the JAX package's ViT has GELU blocks only. A SwiGLU
block (`models/dinov2.py`, `ViTConfig(ffn="swiglu")`, the release's
`SwiGLUFFNFused`) computes w3(silu(a) * b) with (a, b) the two halves of
w12's output, a the first. `gate` takes that (..., 2h) output and returns
(..., h): silu(a) * b in float32 from the input's values, rounded once to the
input's type (bfloat16 on the serving path; float32 too).

On the H100 (source `csrc/swiglu.cu`): each thread reads 16 bytes of a and
16 of b and writes 16 bytes of the product, neighbouring threads on
neighbouring addresses, one row per grid row. So a half must be whole 16-byte
vectors at a 16-byte aligned address (SwiGLU's hidden width is a multiple of
8); `gate` refuses anything else on the card with a `ValueError`. The gate is 6 bytes an
element in bfloat16 and bound by HBM bandwidth: at a ViT-g/14 crop at
stride 8 (1029 tokens, h = 4096) 25.3 MB a block, about 7.5 us at 3.35
TB/s. The same formula in plain PyTorch from a bfloat16 input, with the silu
in float32, moves about 40 bytes an element.

`gate` launches the kernel for CUDA tensors and uses the plain version only
for CPU tensors; there is no fallback between the two. It has no backward:
it raises when autograd would need one (the ViT's "hbm" and "chunked"
routes take `gate_plain`, which autograd follows).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cppf2_torch.ops import _build

SOURCE = "cppf2_torch/csrc/swiglu.cu"
REPLACES = None   # no TPU kernel: the JAX package's ViT has no gated block


def gate_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: silu of the first half times the second, in
    float32, rounded once to `x`'s type."""
    h = x.shape[-1] // 2
    return (F.silu(x[..., :h].float()) * x[..., h:].float()).to(x.dtype)


def _check(x: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the gate takes bfloat16 or float32, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] == 0 or x.shape[-1] % 2:
        raise ValueError(f"the gate takes (..., 2h) with h > 0, got {tuple(x.shape)}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("the gate kernel has no backward: use gate_plain, or call it under "
                           "torch.no_grad()")


def gate(x: torch.Tensor) -> torch.Tensor:
    """silu(a) * b of the halves (a, b) of `x`'s last axis, in one launch on
    a CUDA tensor. Raises when gradients are enabled and `x` requires one."""
    _check(x)
    if x.device.type == "cpu":
        return gate_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    h = x.shape[-1] // 2
    if (h * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(f"the gate kernel takes halves of whole 16-byte vectors at 16-byte "
                         f"aligned addresses, got h = {h} of {x.dtype} at {x.data_ptr():#x}")
    out = torch.empty((*x.shape[:-1], h), dtype=x.dtype, device=x.device)
    _build.launch("swiglu", "cppf2_swiglu_gate",
                  [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p], x.device, x.data_ptr(), out.data_ptr(),
                  x.numel() // (2 * h), h, int(x.dtype == torch.float32))
    return out
