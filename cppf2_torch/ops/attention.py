"""Kernel K1: multi-head attention forward for the DINOv2 ViT.

Replaces the TPU kernel `cppf2_tpu/ops/pallas_attention.py::mha_pallas`
(`_mha_kernel`, pallas_call at :89). Layout (h, T, hd) as there, or
(b, h, T, hd) for b images in one launch; q is pre-scaled by 1/sqrt(hd); keys
at or beyond `t_real` are masked out; exp(logits - max) is rounded to bf16
before the PV product; the output is divided by the f32 row sum after PV.

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

The tensor maps are 4-D and take a stride per axis, so q, k and v may be
views with a contiguous last axis: the heads of a (T, 3 * h * 64) projection,
or of a (b, T, 3 * h * 64) one, whose image stride is no multiple of its head
stride. Such a view is read in place; any other layout is copied first.

The kernel has no backward (the TPU kernel has none either): `mha` raises
when autograd would need one. The differentiable route is the ViT's
`attn_impl="hbm"` formulation (`models/dinov2.py`).

`mha` launches the kernel for CUDA tensors and uses the plain version only
for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cppf2_torch.ops import _build

SOURCE = "cppf2_torch/csrc/attention.cu"
REPLACES = "cppf2_tpu/ops/pallas_attention.py:89"  # the TPU kernel's pallas_call
_HD = 64
_MAX_IMAGES = 65535
_ready = set()   # device indices whose kernel may use its shared memory (cppf2_mha_setup)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t_real: Optional[int] = None,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: f32 logits of the bf16 inputs, key mask,
    exp(logits - max) rounded to bf16 for PV, division by the f32 sum."""
    t = q.shape[-2]
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
        if x.dtype != torch.bfloat16 or x.dim() not in (3, 4):
            raise ValueError(f"{name} must be (h, T, hd) or (b, h, T, hd) bfloat16, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v lie on different devices")
    if not 1 <= t_real <= q.shape[-2]:
        raise ValueError(f"t_real must be in [1, T={q.shape[-2]}], got {t_real}")
    if q.dim() == 4 and q.shape[0] > _MAX_IMAGES:
        raise ValueError(f"one launch takes at most {_MAX_IMAGES} images (the grid's z extent), "
                         f"got {q.shape[0]}: split the batch")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "mha has no backward: its output would be cut from the autograd graph and the "
            "layers before it would stop training. Build the ViT with attn_impl=\"hbm\" "
            "(ViTConfig) for a differentiable attention, or call mha under torch.no_grad()")


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t_real: Optional[int] = None,
        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Full-softmax attention over (h, T, hd) or (b, h, T, hd) bf16 q/k/v ->
    the same shape in `out_dtype`, in one launch. Raises when gradients are
    enabled and q, k or v requires one."""
    t_real = q.shape[-2] if t_real is None else int(t_real)
    _check(q, k, v, t_real, out_dtype)
    if q.device.type == "cpu":
        return mha_plain(q, k, v, t_real, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    shape = q.shape
    if q.dim() == 3:
        q, k, v = q[None], k[None], v[None]
    b, h, t, hd = q.shape
    if hd != _HD:
        raise ValueError(f"the CUDA kernel takes head dim {_HD}, got {hd}")
    idx = torch.cuda.current_device() if q.device.index is None else q.device.index
    if idx not in _ready:
        # the kernel's shared memory is allowed once per device, before its first launch
        with torch.cuda.device(idx):
            _build.check(_build.function("attention", "cppf2_mha_setup", [])(), "mha setup")
        _ready.add(idx)
    q, k, v = (x if _tma_readable(x) else x.contiguous() for x in (q, k, v))
    strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, k, v) for i in (0, 1, 2)))
    out = torch.empty(shape, dtype=out_dtype, device=q.device)
    _build.launch("attention", "cppf2_mha_fwd",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t, t_real,
                  int(out_dtype == torch.float32), strides)
    return out


def _tma_readable(x: torch.Tensor) -> bool:
    """A tensor map needs a contiguous last axis, a 16-byte aligned base and
    positive strides that are multiples of 16 bytes (8 bf16 values); an
    expanded view (stride 0) is not one and is copied."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s > 0 and s % 8 == 0 for s in x.stride()[:-1]))
