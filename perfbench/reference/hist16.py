"""The 16^3 vote histogram and its peak, plain PyTorch (a frozen copy of the
plain versions beside the port's kernel K2, `cppf2_torch/ops/hist16.py`).

Quantization floor((cand - lo) / cell + 0.5), the in-window test, exact
integer counts and the argmax with ties toward the lowest flat index. The
reference's `vote_center` calls `hist16_level_peak`, which writes the
candidates out and counts them row by row.
"""

from __future__ import annotations

from typing import Tuple

import torch

_G = 16
_BINS = _G * _G * _G


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


hist16_peak = hist16_peak_plain
hist16_level_peak = hist16_level_peak_plain
