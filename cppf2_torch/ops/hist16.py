"""Kernel K2: the joint 16^3 vote histogram and its peak.

Replaces the TPU kernel `cppf2_tpu/ops/pallas_kernels.py::hist16_pallas`
(`_hist16_kernel`, pallas_call at :69) and computes what its XLA twin
`cppf2_tpu/ops/voting.py::_hist16_matmul` computes: quantization
floor((cand - lo) / cell + 0.5), the in-window test, exact integer counts and
the argmax with ties toward the lowest flat index.

On the H100 (source `csrc/hist16.cu`): a per-block shared-memory histogram of
4096 int32 bins with the quantization fused before the shared atomic, a
global-atomic merge, and a one-block argmax pass. At V = 400k the call reads
5.2 MB (about 1.6 us at 3.35 TB/s), so its two launches bound it; the
candidates still pass through device memory (fusing their generation into
the kernel is later work).

`hist16_peak` launches the kernel for CUDA tensors and uses the plain
version only for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

SOURCE = "cppf2_torch/csrc/hist16.cu"
REPLACES = "cppf2_tpu/ops/pallas_kernels.py:69"  # the TPU kernel's pallas_call
_G = 16
_BINS = _G * _G * _G


def _quantize(cand, ok, lo, cell):
    f = torch.floor((cand - lo) / cell + 0.5)
    inside = torch.all((f >= 0) & (f < _G), dim=-1) & ok
    ids = torch.clamp(f, 0, _G - 1).to(torch.int64)
    flat = (ids[:, 0] * _G + ids[:, 1]) * _G + ids[:, 2]
    return flat, inside


def hist16_counts_plain(cand, ok, lo, cell) -> torch.Tensor:
    """(4096,) int32 counts, flat index x*256 + y*16 + z."""
    flat, inside = _quantize(cand, ok, lo, cell)
    counts = torch.zeros(_BINS, dtype=torch.int32, device=cand.device)
    return counts.index_add_(0, flat, inside.to(torch.int32))


def hist16_peak_plain(cand, ok, lo, cell) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (peak cell center (3,), count ())."""
    counts = hist16_counts_plain(cand, ok, lo, cell)
    best = torch.argmax(counts)          # the first maximum
    ids = torch.stack([best // (_G * _G), (best % (_G * _G)) // _G, best % _G])
    center = lo + ids.to(cand.dtype) * cell
    return center, counts[best].to(torch.float32)


def _check(cand, ok, lo, cell):
    if cand.dtype != torch.float32 or cand.dim() != 2 or cand.shape[1] != 3:
        raise ValueError(f"cand must be (V, 3) float32, got {tuple(cand.shape)} {cand.dtype}")
    if ok.dtype != torch.bool or ok.shape != cand.shape[:1]:
        raise ValueError(f"ok must be (V,) bool, got {tuple(ok.shape)} {ok.dtype}")
    for name, t in (("lo", lo), ("cell", cell)):
        if t.dtype != torch.float32 or t.shape != (3,):
            raise ValueError(f"{name} must be (3,) float32, got {tuple(t.shape)} {t.dtype}")
    devs = {t.device for t in (cand, ok, lo, cell)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    if cand.shape[0] >= 2 ** 31:
        raise ValueError("more than 2^31 votes")


def hist16_peak(cand: torch.Tensor, ok: torch.Tensor, lo: torch.Tensor,
                cell: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peak of the 16^3 histogram of `cand` (V, 3) over the window at `lo`
    with per-axis `cell`; `ok` (V,) masks votes. Returns (center (3,), count ())."""
    _check(cand, ok, lo, cell)
    if cand.device.type == "cpu":
        return hist16_peak_plain(cand, ok, lo, cell)
    if cand.device.type != "cuda":
        raise ValueError(f"unsupported device {cand.device}")
    from cppf2_torch.ops import _build

    lib = _build.load("hist16")
    fn = lib.cppf2_hist16_peak
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cand = cand.contiguous()
    ok_u8 = ok.contiguous().view(torch.uint8)
    lo = lo.contiguous()
    cell = cell.contiguous()
    counts = torch.zeros(_BINS, dtype=torch.int32, device=cand.device)
    center = torch.empty(3, dtype=torch.float32, device=cand.device)
    peak = torch.empty((), dtype=torch.float32, device=cand.device)
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    with torch.cuda.device(cand.device):
        err = fn(cand.data_ptr(), ok_u8.data_ptr(), cand.shape[0], lo.data_ptr(),
                 cell.data_ptr(), counts.data_ptr(), center.data_ptr(), peak.data_ptr(), stream)
    _build.check(err, "hist16_peak")
    hist16_peak.launches += 1
    return center, peak


hist16_peak.launches = 0
