"""Hough voting: center pyramid, noisy-pair filter, rotation votes.

Counterpart of `cppf2_tpu/ops/voting.py` (reference train_dino.py:171-239,
eval.py:37-51, 252-293). `vote_center` runs each level through kernel K2's
fused entry (`ops/hist16.py::hist16_level_peak`, which makes the level's
candidates itself) and `sphere_vote` its accumulation through kernel K3
(`ops/sphere.py`), each looked up on its module at call time.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from cppf2_torch.core.geometry import norm
from cppf2_torch.ops import hist16, sphere

_EPS = 1e-7
_COARSE_SAMPLES = 16   # arc samples per pair at the coarse levels
_FINE_SPAN = 0.65      # fine-level arc span, in window half-widths per odist


def _pair_frames(a: torch.Tensor, b: torch.Tensor):
    """Unit pair direction, its length and an orthonormal basis (x0, y0) of
    its normal plane (train_dino.py:185-192)."""
    ab = a - b
    ab_norm = norm(ab, keepdim=True)
    abu = ab / torch.clamp(ab_norm, min=_EPS)
    zero = torch.zeros_like(abu[..., 0])
    co = torch.stack([zero, -abu[..., 2], abu[..., 1]], dim=-1)
    co_bad = norm(co, keepdim=True) < _EPS
    co_alt = torch.stack([-abu[..., 1], abu[..., 0], zero], dim=-1)
    co = torch.where(co_bad, co_alt, co)
    x0 = co / torch.clamp(norm(co, keepdim=True), min=_EPS)
    y0 = torch.linalg.cross(x0, abu, dim=-1)
    return abu, ab_norm[..., 0], x0, y0


def _linspace(n: int, device) -> torch.Tensor:
    """jnp.linspace(-1, 1, n) by its float32 lerp, start*(1-t) + stop*t (XLA
    fuses parts of it into multiply-adds, so entries may differ by one ulp)."""
    step = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
    out = np.float32(-1.0) * (np.float32(1.0) - step) + np.float32(1.0) * step
    return torch.from_numpy(np.append(out, np.float32(1.0)).astype(np.float32)).to(device)


class CenterVote(NamedTuple):
    center: torch.Tensor      # (3,)
    peak_count: torch.Tensor  # ()


def vote_center(
    points: torch.Tensor,
    point_valid: torch.Tensor,
    tr_preds: torch.Tensor,
    pair_idx: torch.Tensor,
    pair_valid: torch.Tensor,
    res: float,
    levels: int,
    fine_samples: int,
) -> CenterVote:
    """Pyramid Hough vote for the object center (see the JAX counterpart).

    Each pair votes along the circle of centers its (proj_len, odist)
    prediction allows; each level histograms arc samples near the current
    window into a 16^3 grid (kernel K2, which samples the arcs itself from
    the per-pair quantities computed here) and shrinks the window 4x around the
    peak, with the cell floored at `res`. `levels` and `fine_samples` have no
    defaults: the caller passes `PipelineConfig.vote_levels` and
    `vote_fine_samples`.
    """
    dt = points.dtype
    dev = points.device
    a = points[pair_idx[:, 0]]
    b = points[pair_idx[:, 1]]
    abu, ab_len, x0, y0 = _pair_frames(a, b)
    proj_len = tr_preds[:, 0]
    odist = tr_preds[:, 1]
    ok = pair_valid & (ab_len > _EPS) & (odist > res)
    c = a - abu * proj_len[:, None]

    big = torch.tensor(1e9, dtype=dt, device=dev)
    pts_lo = torch.amin(torch.where(point_valid[:, None], points, big), dim=0)
    pts_hi = torch.amax(torch.where(point_valid[:, None], points, -big), dim=0)

    g = 16
    cell = torch.clamp((pts_hi - pts_lo) / (g - 1), min=res)
    lo = pts_lo
    center = (pts_lo + pts_hi) / 2.0
    count = torch.zeros((), dtype=torch.float32, device=dev)

    n_pairs = c.shape[0]
    for level in range(levels):
        coarse = level < levels - 2
        sub = n_pairs // 8 if coarse and n_pairs >= 8192 else n_pairs
        n_smp = _COARSE_SAMPLES if coarse else fine_samples
        spanf = 1.2 if coarse else _FINE_SPAN
        c_l, x0_l, y0_l = c[:sub], x0[:sub], y0[:sub]
        od_l, ok_l = odist[:sub], ok[:sub]

        if level == 0:
            # the whole-cloud window: a shared full-circle angle table
            ang = torch.arange(n_smp, dtype=dt, device=dev) / n_smp * 2 * torch.pi
            center, count = hist16.hist16_level_peak(
                c_l, x0_l, y0_l, od_l, ok_l, torch.stack([torch.cos(ang), torch.sin(ang)]), lo, cell)
        else:
            # arc samples around the point of each circle nearest the window center
            window_half = torch.amax(cell) * (g / 2)
            rel = center[None, :] - c_l
            u = torch.sum(rel * x0_l, dim=-1)
            v = torch.sum(rel * y0_l, dim=-1)
            theta_star = torch.atan2(v, u)
            span = torch.clamp(spanf * window_half / torch.clamp(od_l, min=_EPS), 0.0, math.pi)
            center, count = hist16.hist16_level_peak(
                c_l, x0_l, y0_l, od_l, ok_l, _linspace(n_smp, dev), lo, cell, theta_star, span)
        cell = torch.clamp(cell / 4.0, min=res)
        lo = center - cell * (g / 2)
    return CenterVote(center, count)


class BackvoteResult(NamedTuple):
    keep: torch.Tensor         # (P,) bool
    pair_weight: torch.Tensor  # (P,) importance weight, 0 if dropped
    kept_idx: torch.Tensor     # (keep_count,) int64 indices of kept pairs


def backvote_filter(
    points: torch.Tensor,
    tr_preds: torch.Tensor,
    pair_idx: torch.Tensor,
    pair_valid: torch.Tensor,
    center: torch.Tensor,
    keep_count: int,
    imp_wt_margin: float = 0.01,
) -> BackvoteResult:
    """Keep the `keep_count` pairs whose predicted (proj_len, odist) best
    match the geometry around the voted center; weight each by the usage of
    its endpoints (eval.py:252-275). Ties keep the lower pair index first."""
    a = points[pair_idx[:, 0]]
    b = points[pair_idx[:, 1]]
    abu, _, _, _ = _pair_frames(a, b)
    rel = a - center
    proj_len = torch.sum(rel * abu, dim=-1)
    oc = rel - proj_len[:, None] * abu
    odist = norm(oc)
    back = torch.stack([proj_len, odist], dim=-1)
    err = norm(tr_preds - back)
    err = torch.where(pair_valid, err, torch.full_like(err, float("inf")))

    neg = -err
    neg_sorted, order = torch.sort(neg, descending=True, stable=True)
    top_idx = order[:keep_count]
    keep = torch.zeros(err.shape, dtype=torch.bool, device=err.device)
    keep[top_idx] = torch.isfinite(neg_sorted[:keep_count])

    flat_idx = pair_idx.reshape(-1).long()
    flat_keep = torch.repeat_interleave(keep, 2).to(torch.float32)
    counts = torch.zeros(points.shape[0], dtype=torch.float32, device=points.device)
    counts = counts.index_add_(0, flat_idx, flat_keep)
    counts = counts / torch.clamp(torch.amax(counts), min=1.0)
    pair_wt = counts[pair_idx[:, 0]] + counts[pair_idx[:, 1]] + imp_wt_margin
    return BackvoteResult(keep, torch.where(keep, pair_wt, torch.zeros_like(pair_wt)), top_idx)


def vote_rotation(
    points: torch.Tensor,
    angle_preds: torch.Tensor,
    pair_idx: torch.Tensor,
    pair_valid: torch.Tensor,
    num_rots: int = 180,
):
    """Candidate axis directions per pair and sweep angle (train_dino.py:
    218-239): every direction at the predicted angle alpha to the unit pair
    direction, `num_rots` steps around its cone,
    up = tan(alpha) * offset + sign(tan(alpha)) * ab_unit, normalized.

    Returns (dirs (P * num_rots, 3), valid (P * num_rots,) bool).
    """
    a = points[pair_idx[:, 0]]
    b = points[pair_idx[:, 1]]
    abu, ab_len, x0, y0 = _pair_frames(a, b)
    ok = pair_valid & (ab_len > _EPS)

    steps = torch.arange(num_rots, dtype=points.dtype, device=points.device)
    angles = steps / num_rots * 2 * torch.pi
    cosv, sinv = torch.cos(angles), torch.sin(angles)
    offset = cosv[None, :, None] * x0[:, None, :] + sinv[None, :, None] * y0[:, None, :]
    tan = torch.tan(angle_preds)
    sign = torch.where(tan > 0, 1.0, -1.0).to(points.dtype)
    up = tan[:, None, None] * offset + sign[:, None, None] * abu[:, None, :]
    up = up / torch.clamp(norm(up, keepdim=True), min=_EPS)
    w = ok[:, None].expand(ok.shape[0], num_rots)
    return up.reshape(-1, 3), w.reshape(-1)


def sphere_vote(
    dirs: torch.Tensor,
    weights: torch.Tensor,
    sphere_pts: torch.Tensor,
    angle_tol_deg: float,
    topk: int = 1,
):
    """Spherical accumulator of candidate directions (eval.py:37-51):
    counts[s] = sum_v weights[v] * [dirs_v . sphere_s > cos(2 * tol)],
    through kernel K3. The weights are rounded to bf16 first and summed in
    f32, as the JAX counterpart's bf16 product does on the TPU.

    Returns (the `topk` sphere directions (topk, 3), their counts (topk,)),
    highest count first, ties to the lower sphere index.
    """
    w = weights.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    counts = sphere.sphere_accumulate(dirs.to(torch.float32)[None], w[None],
                                      sphere_pts.to(torch.float32), angle_tol_deg)[0]
    _, order = torch.sort(counts, descending=True, stable=True)
    idx = order[:topk]
    return sphere_pts[idx], counts[idx]


def sphere_vote_cone(
    points: torch.Tensor,
    angle_preds: torch.Tensor,
    pair_idx: torch.Tensor,
    weights: torch.Tensor,
    sphere_pts: torch.Tensor,
    angle_tol_deg: float,
):
    """Closed-form cone-arc rotation votes for A axes at once, top-1 each.

    `angle_preds` is (A, P): each pair's predicted angle to each axis. The
    count at sphere point s is sum_p w_p * |arc of pair p's candidate cone
    within 2*tol of s| / 2pi, in closed form (see the JAX counterpart).
    Returns (directions (A, 3), scores (A,)); the top-1 is the first maximum.
    """
    a = points[pair_idx[:, 0]]
    b = points[pair_idx[:, 1]]
    abu, ab_len, x0, y0 = _pair_frames(a, b)
    ok = (weights > 0) & (ab_len > _EPS)

    tan = torch.clamp(torch.tan(angle_preds), -1e4, 1e4)
    abs_tan = torch.abs(tan)
    sign = torch.where(tan > 0, 1.0, -1.0).to(points.dtype)
    inv_norm = 1.0 / torch.sqrt(1.0 + tan * tan)

    sph_t = sphere_pts.t()
    xs, ys, as_ = x0 @ sph_t, y0 @ sph_t, abu @ sph_t   # (P, S), shared by the axes
    thresh = torch.cos(torch.tensor(2 * angle_tol_deg / 180.0 * math.pi, dtype=torch.float32))
    r_amp = abs_tan[..., None] * torch.sqrt(xs * xs + ys * ys)[None]
    rhs = thresh / torch.clamp(inv_norm, min=_EPS)[..., None] - sign[..., None] * as_[None]
    ratio = rhs / torch.clamp(r_amp, min=_EPS)
    frac = torch.arccos(torch.clamp(ratio, -1.0, 1.0)) / math.pi
    frac = torch.where(r_amp < 1e-6, (rhs < 0).to(points.dtype), frac)

    w = torch.where(ok, weights, torch.zeros_like(weights)).to(torch.float32)
    counts = torch.einsum("p,aps->as", w, frac.to(torch.float32))
    idx = torch.argmax(counts, dim=-1)
    return sphere_pts[idx], counts.gather(1, idx[:, None])[:, 0]
