"""Hough voting: center pyramid, noisy-pair filter, rotation votes.

Counterpart of `cppf2_tpu/ops/voting.py` (reference train_dino.py:171-239,
eval.py:37-51, 252-293). `vote_center` runs each level through kernel K2's
fused entry (`ops/hist16.py::hist16_level_peak`, which makes the level's
candidates itself) and `sphere_vote` its accumulation through kernel K3
(`ops/sphere.py`), each looked up on its module at call time.

`vote_center`, `backvote_filter` and `sphere_vote_cone` take a leading row
axis: a row is one (instance, branch) pair of the pose graph, the axis the
JAX package adds with jax.vmap over branches and instances. Each row gives
what a call on that row alone gives, to the bit on the CPU: the pyramid
makes one K2 launch per level for all rows, the noisy-pair filter sorts and
counts row by row inside one call, and the cone votes contract each row in
the single-row order.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference.geometry import norm
from perfbench.reference.device import device_constant
from perfbench.reference import hist16, sphere

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


@functools.lru_cache(maxsize=None)
def _cone_threshold(angle_tol_deg: float) -> float:
    """cos(2 tol) of the float32 angle, in float32, as a host number, which
    a tensor filled with it carries to the device without a copy."""
    return float(torch.cos(torch.tensor(2 * angle_tol_deg / 180.0 * math.pi, dtype=torch.float32)))


def _linspace(n: int, device) -> torch.Tensor:
    """jnp.linspace(-1, 1, n) by its float32 lerp, start*(1-t) + stop*t (XLA
    fuses parts of it into multiply-adds, so entries may differ by one ulp)."""
    step = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
    out = np.float32(-1.0) * (np.float32(1.0) - step) + np.float32(1.0) * step
    table = np.append(out, np.float32(1.0)).astype(np.float32)
    return device_constant(("linspace", n), lambda: torch.from_numpy(table), device)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every row b: x (B, N, ...), idx (B, ...) integer."""
    rows = torch.arange(x.shape[0], device=x.device).view(-1, *([1] * (idx.dim() - 1)))
    return x[rows, idx]


def _one_row(fn, *args):
    """`fn` on a single row: a leading axis of 1 on every tensor argument,
    dropped again from every tensor of the result."""
    out = fn(*(a[None] if isinstance(a, torch.Tensor) else a for a in args))
    return type(out)(*(x[0] for x in out))


class CenterVote(NamedTuple):
    center: torch.Tensor      # (3,), or (B, 3) for rows
    peak_count: torch.Tensor  # (), or (B,)


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

    Rows: points (B, N, 3), point_valid (B, N), tr_preds (B, P, 2),
    pair_idx (B, P, 2) and pair_valid (B, P) give centers (B, 3) and counts
    (B,), each level one K2 launch for all B rows.
    """
    single = points.dim() == 2
    if single:
        points, point_valid, tr_preds, pair_idx, pair_valid = (
            x[None] for x in (points, point_valid, tr_preds, pair_idx, pair_valid))

    def peak(*args):
        # a single row's level keeps its single-row shapes at K2's entry; the
        # sample table (argument 5) is shared by the rows
        if not single:
            return hist16.hist16_level_peak(*args)
        center, count = hist16.hist16_level_peak(
            *(x if i == 5 or x is None else x[0] for i, x in enumerate(args)))
        return center[None], count[None]

    dt = points.dtype
    dev = points.device
    a = take_rows(points, pair_idx[..., 0])
    b = take_rows(points, pair_idx[..., 1])
    abu, ab_len, x0, y0 = _pair_frames(a, b)
    proj_len = tr_preds[..., 0]
    odist = tr_preds[..., 1]
    ok = pair_valid & (ab_len > _EPS) & (odist > res)
    c = a - abu * proj_len[..., None]

    big = torch.full((), 1e9, dtype=dt, device=dev)
    pts_lo = torch.amin(torch.where(point_valid[..., None], points, big), dim=1)
    pts_hi = torch.amax(torch.where(point_valid[..., None], points, -big), dim=1)

    g = 16
    cell = torch.clamp((pts_hi - pts_lo) / (g - 1), min=res)
    lo = pts_lo
    center = (pts_lo + pts_hi) / 2.0
    count = torch.zeros(points.shape[0], dtype=torch.float32, device=dev)

    n_pairs = c.shape[1]
    for level in range(levels):
        coarse = level < levels - 2
        sub = n_pairs // 8 if coarse and n_pairs >= 8192 else n_pairs
        n_smp = _COARSE_SAMPLES if coarse else fine_samples
        spanf = 1.2 if coarse else _FINE_SPAN
        c_l, x0_l, y0_l = c[:, :sub], x0[:, :sub], y0[:, :sub]
        od_l, ok_l = odist[:, :sub], ok[:, :sub]

        if level == 0:
            # the whole-cloud window: a shared full-circle angle table
            ang = torch.arange(n_smp, dtype=dt, device=dev) / n_smp * 2 * torch.pi
            table = torch.stack([torch.cos(ang), torch.sin(ang)])
            center, count = peak(c_l, x0_l, y0_l, od_l, ok_l, table, lo, cell)
        else:
            # arc samples around the point of each circle nearest the window center
            window_half = torch.amax(cell, dim=-1, keepdim=True) * (g / 2)
            rel = center[:, None, :] - c_l
            u = torch.sum(rel * x0_l, dim=-1)
            v = torch.sum(rel * y0_l, dim=-1)
            theta_star = torch.atan2(v, u)
            span = torch.clamp(spanf * window_half / torch.clamp(od_l, min=_EPS), 0.0, math.pi)
            center, count = peak(
                c_l, x0_l, y0_l, od_l, ok_l, _linspace(n_smp, dev), lo, cell, theta_star, span)
        cell = torch.clamp(cell / 4.0, min=res)
        lo = center - cell * (g / 2)
    return CenterVote(center[0], count[0]) if single else CenterVote(center, count)


class BackvoteResult(NamedTuple):
    keep: torch.Tensor         # (P,) bool, or (B, P) for rows
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
    its endpoints (eval.py:252-275). Ties keep the lower pair index first.

    Rows: points (B, N, 3), tr_preds (B, P, 2), pair_idx (B, P, 2),
    pair_valid (B, P) and center (B, 3); each row sorts its own pairs (a
    stable sort along the last axis) and counts its own endpoints (one
    index_add_ with a row offset; the counts are integers, so exact)."""
    if points.dim() == 2:
        return _one_row(backvote_filter, points, tr_preds, pair_idx, pair_valid, center,
                        keep_count, imp_wt_margin)
    n_rows, n_pts = points.shape[:2]
    a = take_rows(points, pair_idx[..., 0])
    b = take_rows(points, pair_idx[..., 1])
    abu, _, _, _ = _pair_frames(a, b)
    rel = a - center[:, None, :]
    proj_len = torch.sum(rel * abu, dim=-1)
    oc = rel - proj_len[..., None] * abu
    odist = norm(oc)
    back = torch.stack([proj_len, odist], dim=-1)
    err = norm(tr_preds - back)
    err = torch.where(pair_valid, err, torch.full_like(err, float("inf")))

    neg = -err
    neg_sorted, order = torch.sort(neg, dim=-1, descending=True, stable=True)
    top_idx = order[:, :keep_count]
    keep = torch.zeros(err.shape, dtype=torch.bool, device=err.device)
    keep.scatter_(1, top_idx, torch.isfinite(neg_sorted[:, :keep_count]))

    offset = torch.arange(n_rows, device=points.device)[:, None, None] * n_pts
    flat_idx = (pair_idx.long() + offset).reshape(-1)
    flat_keep = torch.repeat_interleave(keep, 2, dim=-1).reshape(-1).to(torch.float32)
    counts = torch.zeros(n_rows * n_pts, dtype=torch.float32, device=points.device)
    counts = counts.index_add_(0, flat_idx, flat_keep).view(n_rows, n_pts)
    counts = counts / torch.clamp(torch.amax(counts, dim=-1, keepdim=True), min=1.0)
    pair_wt = (take_rows(counts, pair_idx[..., 0]) + take_rows(counts, pair_idx[..., 1])
               + imp_wt_margin)
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

    Rows: points (B, N, 3), angle_preds (B, A, P), pair_idx (B, P, 2) and
    weights (B, P) give (B, A, 3) and (B, A). Every row's arc map is made at
    once; the weighted sum over pairs, whose counts feed the argmax, is
    taken row by row in the single-row order.
    """
    if points.dim() == 2:
        dirs, scores = sphere_vote_cone(points[None], angle_preds[None], pair_idx[None],
                                        weights[None], sphere_pts, angle_tol_deg)
        return dirs[0], scores[0]
    n_rows, n_pairs = pair_idx.shape[:2]
    a = take_rows(points, pair_idx[..., 0])
    b = take_rows(points, pair_idx[..., 1])
    abu, ab_len, x0, y0 = _pair_frames(a, b)
    ok = (weights > 0) & (ab_len > _EPS)

    tan = torch.clamp(torch.tan(angle_preds), -1e4, 1e4)
    abs_tan = torch.abs(tan)
    sign = torch.where(tan > 0, 1.0, -1.0).to(points.dtype)
    inv_norm = 1.0 / torch.sqrt(1.0 + tan * tan)

    sph_t = sphere_pts.t()

    def dots(v):   # (B, P, S), shared by the axes; one product over all rows' pairs
        return (v.reshape(-1, 3) @ sph_t).reshape(n_rows, n_pairs, -1)

    xs, ys, as_ = dots(x0), dots(y0), dots(abu)
    # a tensor operand: `number / tensor` would multiply by the tensor's reciprocal instead
    thresh = torch.full((), _cone_threshold(angle_tol_deg), dtype=torch.float32,
                        device=points.device)
    r_amp = abs_tan[..., None] * torch.sqrt(xs * xs + ys * ys)[:, None]
    rhs = thresh / torch.clamp(inv_norm, min=_EPS)[..., None] - sign[..., None] * as_[:, None]
    ratio = rhs / torch.clamp(r_amp, min=_EPS)
    frac = torch.arccos(torch.clamp(ratio, -1.0, 1.0)) / math.pi
    frac = torch.where(r_amp < 1e-6, (rhs < 0).to(points.dtype), frac)

    w = torch.where(ok, weights, torch.zeros_like(weights)).to(torch.float32)
    frac = frac.to(torch.float32)
    counts = torch.stack([torch.einsum("p,aps->as", w[i], frac[i]) for i in range(n_rows)])
    idx = torch.argmax(counts, dim=-1)
    return sphere_pts[idx], counts.gather(-1, idx[..., None])[..., 0]
