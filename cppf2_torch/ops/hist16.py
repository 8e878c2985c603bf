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
memory and the counts stay exactly those of the plain version. It takes B
rows at once (a leading axis on every per-pair input and on the window; the
sample table is shared), one launch for all of them: a row is one
(instance, branch) pair of the pose graph, which the JAX package batches with
jax.vmap. Each row's peak is the one a launch of that row alone gives.

On the H100 a call is a few microseconds of work (5.2 MB of candidates at
V = 400k, about 1.6 us at 3.35 TB/s; 2.5 MB of pair data for a fused fine
level), so launches and the contended shared-memory adds set its time, not
bytes. The design answers both: a per-block shared histogram whose adds are
aggregated per warp first, a global-atomic merge, and the last block to
finish takes the argmax and clears the counts, so the wrapper keeps one
zeroed scratch buffer per device instead of a memset and a second kernel per
call. A captured program (`eval/programs.py`) owns a scratch of its own
instead (`owned_scratch`): the device's is replaced when a launch needs more
rows, and a launch on another stream than the last synchronizes the device,
neither of which a CUDA graph may do.

Both entries launch the kernel for CUDA tensors and use their plain version
only for CPU tensors; there is no fallback between the two. Every launch,
through either entry, adds one to `hist16_peak.launches` (the count of K2
launches); `hist16_level_peak.launches` counts the fused ones alone.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, Optional, Tuple

import torch

SOURCE = "cppf2_torch/csrc/hist16.cu"
REPLACES = "cppf2_tpu/ops/pallas_kernels.py:69"  # the TPU kernel's pallas_call
_G = 16
_BINS = _G * _G * _G
_MAX_ROWS = 65535  # the grid's y extent
# device index -> [zeroed (rows, 4096 counts and a ticket), the stream last used]
_scratch: Dict[int, List] = {}
# [the zeroed scratch of a program, or None], while `owned_scratch` is open
_owned: Optional[List] = None


@contextlib.contextmanager
def owned_scratch(holder: List):
    """Launches inside use `holder[0]`, a zeroed int32 (rows, 4097) scratch
    that the caller owns and keeps, in place of the device's. Where it is None
    or holds fewer rows than a launch, that launch first puts a larger zeroed
    one there; inside a CUDA graph capture it raises instead, so a program
    runs once before its capture (its warm-up) to size its scratch. The
    kernel leaves the scratch zeroed, so the owner replays its graph without
    a memset."""
    global _owned
    outer, _owned = _owned, holder
    try:
        yield holder
    finally:
        _owned = outer


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
    return center, counts.gather(0, best.reshape(1))[0].to(torch.float32)


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


def _launch(symbol: str, argtypes, dev: torch.device, rows: int, *args) -> torch.Tensor:
    """Launch one K2 entry for `rows` rows on `dev`'s current stream: `args`,
    then the device's zeroed scratch (per row 4096 counts and a ticket, which
    the kernel leaves zeroed), a fresh (rows, 4) output and the stream;
    returns the output, each row's center and count. Launches on one stream
    reuse the scratch in stream order, and a launch with more rows than it
    holds replaces it by a larger zeroed one; a launch on another stream than
    the last one first waits for the device. Inside `owned_scratch` the
    holder's scratch is used instead. A launch that fails drops the scratch,
    so that the next one starts from zeros."""
    from cppf2_torch.ops import _build

    fn = _build.function("hist16", symbol, list(argtypes) + [ctypes.c_void_p] * 3)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if _owned is not None:
        scratch = _owned[0]
        if scratch is None or scratch.shape[0] < rows or scratch.device.index != idx:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{symbol}: a program's K2 scratch holds no {rows} rows at its "
                                   f"capture; it must run once before it is captured")
            scratch = _owned[0] = torch.zeros((rows, _BINS + 1), dtype=torch.int32, device=dev)
    else:
        stream = _build.raw_stream(idx)
        entry = _scratch.get(idx)
        if entry is not None and entry[1] != stream:
            torch.cuda.synchronize(idx)
            entry[1] = stream
        if entry is None or entry[0].shape[0] < rows:
            entry = _scratch[idx] = [torch.zeros((rows, _BINS + 1), dtype=torch.int32, device=dev),
                                     stream]
        scratch = entry[0]
    out = torch.empty((rows, 4), dtype=torch.float32, device=dev)
    err = _build.launch(fn, dev, *args, scratch.data_ptr(), out.data_ptr())
    if err != 0:
        if _owned is not None:
            _owned[0] = None
        else:
            del _scratch[idx]
    _build.check(err, symbol)
    _PEAK.launches += 1
    return out


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
    out = _launch("cppf2_hist16_peak",
                  [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2,
                  cand.device, 1, cand.data_ptr(), ok_u8.data_ptr(), cand.shape[0], lo.data_ptr(),
                  cell.data_ptr())[0]
    return out[:3], out[3]


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
    then `hist16_peak_plain`; with a leading row axis, row by row, stacked."""
    if c.dim() == 3:
        arcs = [(None, None)] * c.shape[0] if theta_star is None else zip(theta_star, span)
        peaks = [hist16_level_peak_plain(*row, samples, lo_r, cell_r, ts, sp)
                 for row, lo_r, cell_r, (ts, sp) in zip(zip(c, x0, y0, odist, ok), lo, cell, arcs)]
        return torch.stack([p[0] for p in peaks]), torch.stack([p[1] for p in peaks])
    cand, ok_v = level_candidates(c, x0, y0, odist, ok, samples, theta_star, span)
    return hist16_peak_plain(cand, ok_v, lo, cell)


def _check_level(c, x0, y0, odist, ok, samples, lo, cell, theta_star, span):
    if c.dtype != torch.float32 or c.dim() not in (2, 3) or c.shape[-1] != 3:
        raise ValueError(f"c must be (P, 3) or (B, P, 3) float32, got {tuple(c.shape)} {c.dtype}")
    lead, pairs = tuple(c.shape[:-2]), tuple(c.shape[:-1])
    if lead and not 1 <= lead[0] <= _MAX_ROWS:
        raise ValueError(f"between 1 and {_MAX_ROWS} rows, got {lead[0]}")
    for name, t in (("x0", x0), ("y0", y0)):
        if t.dtype != torch.float32 or t.shape != c.shape:
            raise ValueError(f"{name} must be {tuple(c.shape)} float32, got {tuple(t.shape)} "
                             f"{t.dtype}")
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
        if t.dtype != torch.float32 or t.shape != pairs:
            raise ValueError(f"{name} must be {pairs} float32, got {tuple(t.shape)} {t.dtype}")
    if ok.dtype != torch.bool or ok.shape != pairs:
        raise ValueError(f"ok must be {pairs} bool, got {tuple(ok.shape)} {ok.dtype}")
    for name, t in (("lo", lo), ("cell", cell)):
        if t.dtype != torch.float32 or t.shape != lead + (3,):
            raise ValueError(f"{name} must be {lead + (3,)} float32, got {tuple(t.shape)} "
                             f"{t.dtype}")
    devs = {t.device for t in (c, x0, y0, odist, ok, samples, lo, cell)}
    devs |= {t.device for _, t in per_pair}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    if pairs[-1] * samples.shape[-1] >= 2 ** 31:
        raise ValueError("more than 2^31 votes a row")


def hist16_level_peak(c: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, odist: torch.Tensor,
                      ok: torch.Tensor, samples: torch.Tensor, lo: torch.Tensor,
                      cell: torch.Tensor, theta_star: Optional[torch.Tensor] = None,
                      span: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peak of the 16^3 histogram of one level's candidates (see
    `level_candidates`) over the window at `lo` with per-axis `cell`, without
    writing the candidates out. Returns (center (3,), count ()).

    Rows: with c, x0, y0 (B, P, 3), odist, ok, theta_star, span (B, P) and
    lo, cell (B, 3), each row is one such level over its own window, all in
    one launch; returns (centers (B, 3), counts (B,)). The sample table is
    shared by the rows."""
    _check_level(c, x0, y0, odist, ok, samples, lo, cell, theta_star, span)
    if c.device.type == "cpu":
        return hist16_level_peak_plain(c, x0, y0, odist, ok, samples, lo, cell, theta_star, span)
    if c.device.type != "cuda":
        raise ValueError(f"unsupported device {c.device}")
    rows = c.shape[0] if c.dim() == 3 else 1
    tensors = [c.contiguous(), x0.contiguous(), y0.contiguous(), odist.contiguous(),
               ok.contiguous().view(torch.uint8), samples.contiguous()]
    arc = [] if theta_star is None else [theta_star.contiguous(), span.contiguous()]
    lo, cell = lo.contiguous(), cell.contiguous()
    ptrs = [t.data_ptr() for t in tensors] + ([t.data_ptr() for t in arc] or [None, None])
    out = _launch("cppf2_hist16_level_peak",
                  [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
                  c.device, rows, *ptrs, rows, c.shape[-2], samples.shape[-1], lo.data_ptr(),
                  cell.data_ptr())
    _LEVEL.launches += 1
    if c.dim() == 2:
        out = out[0]
    return out[..., :3], out[..., 3]


hist16_level_peak.launches = 0
_LEVEL = hist16_level_peak
