"""Kernel K2: the joint 16^3 vote histogram and its peak.

Replaces the TPU kernel `cppf2_tpu/ops/pallas_kernels.py::hist16_pallas`
(`_hist16_kernel`, pallas_call at :69) and computes what its XLA twin
`cppf2_tpu/ops/voting.py::_hist16_matmul` computes: quantization
floor((cand - lo) / cell + 0.5), the in-window test, exact integer counts and
the argmax with ties toward the lowest flat index.

Two entries, one source (`csrc/hist16.cu`), one launch each:

`hist16_peak(cand, ok, lo, cell)` is the direct counterpart of the TPU kernel:
votes read from a (V, 3) candidate array.

`hist16_level_peak(...)` is one level of `vote_center`: it takes the per-pair
quantities and the level's sample table and makes every (pair, sample)
candidate c + (cos t * x0 + sin t * y0) * odist inside the kernel, in the
plain version's rounding order, so no candidate tensor is written to device
memory and the counts stay exactly those of the plain version.

On the H100 a call is a few microseconds of work (5.2 MB of candidates at
V = 400k, about 1.6 us at 3.35 TB/s; 2.5 MB of pair data for a fused fine
level), so launches and the contended shared-memory adds set its time, not
bytes. The design answers both: a per-block shared histogram whose adds are
aggregated per warp first, a global-atomic merge, and the last block to
finish takes the argmax and clears the counts, so the wrapper keeps one
zeroed scratch buffer per device instead of a memset and a second kernel per
call.

Both entries launch the kernel for CUDA tensors and use their plain version
only for CPU tensors; there is no fallback between the two. Every launch,
through either entry, adds one to `hist16_peak.launches` (the count of K2
launches); `hist16_level_peak.launches` counts the fused ones alone.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

SOURCE = "cppf2_torch/csrc/hist16.cu"
REPLACES = "cppf2_tpu/ops/pallas_kernels.py:69"  # the TPU kernel's pallas_call
_G = 16
_BINS = _G * _G * _G
_scratch: Dict[int, List] = {}   # device index -> [zeroed counts and ticket, the stream last used]


def _quantize(cand, ok, lo, cell):
    f = torch.floor((cand - lo) / cell + 0.5)
    inside = torch.all((f >= 0) & (f < _G), dim=-1) & ok
    # a vote of an empty cloud is NaN: it is not inside, and its id must still be a valid index
    ids = torch.clamp(torch.nan_to_num(f, nan=0.0), 0, _G - 1).to(torch.int64)
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


def _launch(symbol: str, argtypes, dev: torch.device, *args):
    """Launch one K2 entry on `dev`'s current stream: `args`, then the
    device's zeroed scratch (4096 counts and a ticket, which the kernel
    leaves zeroed), a fresh (4,) output and the stream; returns
    (center (3,), count ()). Launches on one stream reuse the scratch in
    stream order; a launch on another stream than the last one first waits
    for the device. A launch that fails drops the scratch, so that the next
    one starts from zeros."""
    from cppf2_torch.ops import _build

    fn = _build.function("hist16", symbol, list(argtypes) + [ctypes.c_void_p] * 3)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    stream = _build.raw_stream(idx)
    entry = _scratch.get(idx)
    if entry is None:
        entry = _scratch[idx] = [torch.zeros(_BINS + 1, dtype=torch.int32, device=dev), stream]
    elif entry[1] != stream:
        torch.cuda.synchronize(idx)
        entry[1] = stream
    out = torch.empty(4, dtype=torch.float32, device=dev)
    err = _build.launch(fn, dev, *args, entry[0].data_ptr(), out.data_ptr())
    if err != 0:
        del _scratch[idx]
    _build.check(err, symbol)
    _PEAK.launches += 1
    return out[:3], out[3]


def hist16_peak(cand: torch.Tensor, ok: torch.Tensor, lo: torch.Tensor,
                cell: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peak of the 16^3 histogram of `cand` (V, 3) over the window at `lo`
    with per-axis `cell`; `ok` (V,) masks votes. Returns (center (3,), count ())."""
    _check(cand, ok, lo, cell)
    if cand.device.type == "cpu":
        return hist16_peak_plain(cand, ok, lo, cell)
    if cand.device.type != "cuda":
        raise ValueError(f"unsupported device {cand.device}")
    cand, ok_u8 = cand.contiguous(), ok.contiguous().view(torch.uint8)
    lo, cell = lo.contiguous(), cell.contiguous()
    return _launch("cppf2_hist16_peak",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
                   cand.device, cand.data_ptr(), ok_u8.data_ptr(), cand.shape[0], lo.data_ptr(),
                   cell.data_ptr())


hist16_peak.launches = 0
_PEAK = hist16_peak   # the counters stay on these functions when a caller swaps the module's names


def level_candidates(c, x0, y0, odist, ok, samples, theta_star=None, span=None):
    """The (sub * n_smp, 3) candidates of one level of the center vote and
    their (sub * n_smp,) mask, pair-major: every sample of every pair's circle
    of centers, c + (cos t * x0 + sin t * y0) * odist. With `theta_star` and
    `span` (sub,), `samples` (n_smp,) holds arc positions and
    t = theta_star + samples * span; without them `samples` (2, n_smp) holds
    the cos and sin of angles shared by all pairs."""
    sub = c.shape[0]
    if theta_star is None:
        cosv, sinv = samples[0], samples[1]
        n_smp = cosv.shape[0]
        offs = (cosv[None, :, None] * x0[:, None, :]
                + sinv[None, :, None] * y0[:, None, :]) * odist[:, None, None]
    else:
        n_smp = samples.shape[0]
        theta = theta_star[:, None] + samples[None, :] * span[:, None]
        offs = (torch.cos(theta)[..., None] * x0[:, None, :]
                + torch.sin(theta)[..., None] * y0[:, None, :]) * odist[:, None, None]
    cand = (c[:, None, :] + offs).reshape(-1, 3)
    return cand, ok[:, None].expand(sub, n_smp).reshape(-1)


def hist16_level_peak_plain(c, x0, y0, odist, ok, samples, lo, cell, theta_star=None,
                            span=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused level: the candidates written out,
    then `hist16_peak_plain`."""
    cand, ok_v = level_candidates(c, x0, y0, odist, ok, samples, theta_star, span)
    return hist16_peak_plain(cand, ok_v, lo, cell)


def _check_level(c, x0, y0, odist, ok, samples, lo, cell, theta_star, span):
    if c.dtype != torch.float32 or c.dim() != 2 or c.shape[1] != 3:
        raise ValueError(f"c must be (P, 3) float32, got {tuple(c.shape)} {c.dtype}")
    sub = c.shape[0]
    for name, t in (("x0", x0), ("y0", y0)):
        if t.dtype != torch.float32 or t.shape != c.shape:
            raise ValueError(f"{name} must be ({sub}, 3) float32, got {tuple(t.shape)} {t.dtype}")
    per_pair = [("odist", odist)]
    if (theta_star is None) != (span is None):
        raise ValueError("theta_star and span go together")
    if theta_star is None:
        want = "(2, n_smp)"
        good = samples.dim() == 2 and samples.shape[0] == 2
    else:
        want = "(n_smp,)"
        good = samples.dim() == 1
        per_pair += [("theta_star", theta_star), ("span", span)]
    if samples.dtype != torch.float32 or not good or samples.shape[-1] < 1:
        raise ValueError(f"samples must be {want} float32, got {tuple(samples.shape)} "
                         f"{samples.dtype}")
    for name, t in per_pair:
        if t.dtype != torch.float32 or t.shape != (sub,):
            raise ValueError(f"{name} must be ({sub},) float32, got {tuple(t.shape)} {t.dtype}")
    if ok.dtype != torch.bool or ok.shape != (sub,):
        raise ValueError(f"ok must be ({sub},) bool, got {tuple(ok.shape)} {ok.dtype}")
    for name, t in (("lo", lo), ("cell", cell)):
        if t.dtype != torch.float32 or t.shape != (3,):
            raise ValueError(f"{name} must be (3,) float32, got {tuple(t.shape)} {t.dtype}")
    devs = {t.device for t in (c, x0, y0, odist, ok, samples, lo, cell)}
    devs |= {t.device for _, t in per_pair}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    if sub * samples.shape[-1] >= 2 ** 31:
        raise ValueError("more than 2^31 votes")


def hist16_level_peak(c: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, odist: torch.Tensor,
                      ok: torch.Tensor, samples: torch.Tensor, lo: torch.Tensor,
                      cell: torch.Tensor, theta_star: Optional[torch.Tensor] = None,
                      span: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peak of the 16^3 histogram of one level's candidates (see
    `level_candidates`) over the window at `lo` with per-axis `cell`, without
    writing the candidates out. Returns (center (3,), count ())."""
    _check_level(c, x0, y0, odist, ok, samples, lo, cell, theta_star, span)
    if c.device.type == "cpu":
        return hist16_level_peak_plain(c, x0, y0, odist, ok, samples, lo, cell, theta_star, span)
    if c.device.type != "cuda":
        raise ValueError(f"unsupported device {c.device}")
    tensors = [c.contiguous(), x0.contiguous(), y0.contiguous(), odist.contiguous(),
               ok.contiguous().view(torch.uint8), samples.contiguous()]
    arc = [] if theta_star is None else [theta_star.contiguous(), span.contiguous()]
    lo, cell = lo.contiguous(), cell.contiguous()
    ptrs = [t.data_ptr() for t in tensors] + ([t.data_ptr() for t in arc] or [None, None])
    result = _launch("cppf2_hist16_level_peak",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2,
                     c.device, *ptrs, c.shape[0], samples.shape[-1], lo.data_ptr(), cell.data_ptr())
    _LEVEL.launches += 1
    return result


hist16_level_peak.launches = 0
_LEVEL = hist16_level_peak
