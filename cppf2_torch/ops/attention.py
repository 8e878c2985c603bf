"""Kernel K1: multi-head attention forward for the DINOv2 ViT.

Replaces the TPU kernel `cppf2_tpu/ops/pallas_attention.py::mha_pallas`
(`_mha_kernel`, pallas_call at :89). Layout (h, T, hd) as there; q is
pre-scaled by 1/sqrt(hd); keys at or beyond `t_real` are masked out;
exp(logits - max) is rounded to bf16 before the PV product; the output is
divided by the f32 row sum after PV.

On the H100 (source `csrc/attention.cu`): one warpgroup per 64 query rows of a
head streams K/V tiles through two shared-memory stages by TMA (a tensor map
per operand, 128-byte swizzle, completion on an mbarrier), so the next tile
is in flight while this one is multiplied; both products are `wgmma` (Q and
K from shared memory, bf16 P from registers, V from shared memory as it lies
in memory: no transposed copy), the online softmax works in base 2, and
several blocks per SM overlap one block's softmax with another's products.
At ViT-L stride 8 (h 16, T 1025, hd 64) one call is 4.3 GFLOP for 8.4 MB of
traffic: bound by the tensor-core rate (about 4.4 us at 989 TFLOP/s bf16);
short of it the exponentials and the barriers between a tile's two products
hold the kernel. The TPU kernel's whole-K/V-in-VMEM single pass does not fit
a Hopper block and is not copied.

The tensor maps take strides, so q, k and v may be (h, T, 64) views with a
contiguous last axis (for one, the heads of a (T, 3 * h * 64) projection):
such a view is read in place; any other layout is copied first.

`mha` launches the kernel for CUDA tensors and uses the plain version only
for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

SOURCE = "cppf2_torch/csrc/attention.cu"
REPLACES = "cppf2_tpu/ops/pallas_attention.py:89"  # the TPU kernel's pallas_call
_HD = 64


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t_real: Optional[int] = None,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: f32 logits of the bf16 inputs, key mask,
    exp(logits - max) rounded to bf16 for PV, division by the f32 sum."""
    t = q.shape[1]
    t_real = t if t_real is None else t_real
    qf = q.to(torch.bfloat16).float()
    kf = k.to(torch.bfloat16).float()
    vf = v.to(torch.bfloat16).float()
    logits = torch.matmul(qf, kf.transpose(-1, -2))
    col = torch.arange(t, device=q.device)
    logits = logits.masked_fill(col >= t_real, float("-inf"))
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    s = torch.sum(e, dim=-1, keepdim=True)
    pv = torch.matmul(e.to(torch.bfloat16).float(), vf)
    return (pv / s).to(out_dtype)


def _check(q, k, v, t_real, out_dtype):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16 or x.dim() != 3:
            raise ValueError(f"{name} must be (h, T, hd) bfloat16, got {tuple(x.shape)} {x.dtype}")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v lie on different devices")
    if not 1 <= t_real <= q.shape[1]:
        raise ValueError(f"t_real must be in [1, T={q.shape[1]}], got {t_real}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t_real: Optional[int] = None,
        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Full-softmax attention over (h, T, hd) bf16 q/k/v -> (h, T, hd) `out_dtype`."""
    t_real = q.shape[1] if t_real is None else int(t_real)
    _check(q, k, v, t_real, out_dtype)
    if q.device.type == "cpu":
        return mha_plain(q, k, v, t_real, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    h, t, hd = q.shape
    if hd != _HD:
        raise ValueError(f"the CUDA kernel takes head dim {_HD}, got {hd}")
    from cppf2_torch.ops import _build

    fn = _build.function("attention", "cppf2_mha_fwd",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    q, k, v = (x if _tma_readable(x) else x.contiguous() for x in (q, k, v))
    strides = (ctypes.c_longlong * 6)(*(x.stride(i) for x in (q, k, v) for i in (0, 1)))
    out = torch.empty((h, t, hd), dtype=out_dtype, device=q.device)
    err = _build.launch(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        h, t, t_real, int(out_dtype == torch.float32), strides)
    _build.check(err, "mha")
    _MHA.launches += 1
    return out


def _tma_readable(x: torch.Tensor) -> bool:
    """A tensor map needs a contiguous last axis, a 16-byte aligned base and
    positive strides that are multiples of 16 bytes (8 bf16 values); an
    expanded view (stride 0) is not one and is copied."""
    return (x.stride(2) == 1 and all(x.stride(i) > 0 and x.stride(i) % 8 == 0 for i in (0, 1))
            and x.data_ptr() % 16 == 0)


mha.launches = 0
_MHA = mha   # the counter stays on this function when a caller swaps the module's name
