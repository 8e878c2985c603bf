"""Depth-geometry instance proposer: the demo's masks without a detector.

Counterpart of `cppf2_tpu/infer/segmenter.py`. The reference's demo takes
masks from a torchvision Mask R-CNN (demo.py:95-115), whose weights are not
here. Depth discontinuities break the scene into surface patches, the
dominant support plane (table, floor) is removed, and the remaining
connected components are ranked against the category's metric scale prior
(`config.py::CategoryConfig.scale_range`).

Host numpy, as in the JAX package: it runs once per frame on a 480 x 640
grid and feeds the mask input of the pose graph. Its masks feed a discrete
ranking, so the OpenCV calls of the JAX module are `utils/imgproc.py`'s
stand-ins, which give the same pixels (the blur the same bits), and every
proposal equals the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from cppf2_torch.utils.imgproc import connected_components, dilate, erode, gaussian_blur5, morph_close


def backproject_grid(depth_m: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """Per-pixel 3D points (H, W, 3) from a depth map (zeros stay zeros).

    Sign conventions don't matter here — only distances and extents are
    consumed downstream."""
    h, w = depth_m.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    z = depth_m.astype(np.float32)
    return np.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], axis=-1)


def grid_normals(points: np.ndarray, valid: np.ndarray,
                 smooth: int = 5, baseline: int = 2) -> np.ndarray:
    """Surface normals of the backprojected grid (H, W, 3); unit length where
    defined, zero where the neighborhood is invalid.

    Real sensor depth carries mm-scale noise; raw 1-px central differences
    at ~3 mm pixel pitch turn that into tens of degrees of normal noise. A
    small Gaussian smooth plus a `baseline`-px difference stencil keeps the
    normals usable for plane voting. `smooth` is 5 (OpenCV's fixed 5-tap
    kernel, `gaussian_blur5`) or at most 1 (no smoothing)."""
    pts = points.astype(np.float32)
    if smooth > 1:
        # normalized convolution: blur valid points only and renormalize by
        # the blurred validity, so zero-parked invalid pixels never bleed
        # toward the origin through the blur (a plain blur biases normals of
        # valid pixels up to smooth//2 px beyond the erode guard below)
        v = valid.astype(np.float32)
        if smooth != 5:
            raise ValueError(f"smooth={smooth}: only the 5-tap blur is reproduced")
        num = gaussian_blur5(pts * v[..., None])
        den = gaussian_blur5(v)
        pts = num / np.maximum(den, 1e-6)[..., None]
    b = baseline
    dx = np.zeros_like(pts)
    dy = np.zeros_like(pts)
    dx[:, b:-b] = pts[:, 2 * b:] - pts[:, : -2 * b]
    dy[b:-b, :] = pts[2 * b:, :] - pts[: -2 * b, :]
    n = np.cross(dx, dy)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 1e-12, n / np.maximum(norm, 1e-12), 0.0)
    # a stencil that straddles an invalid pixel is garbage: zero it
    ok = erode(valid.astype(np.uint8), 2 * b + 1) > 0
    return np.where(ok[..., None], n, 0.0)


def depth_edges(depth_m: np.ndarray, valid: np.ndarray,
                jump_abs: float = 0.012, jump_rel: float = 0.02) -> np.ndarray:
    """Depth-discontinuity pixels: the local min->max depth jump over the
    VALID pixels of a 3x3 window exceeds max(jump_abs, jump_rel * z).
    Invalid neighbors are excluded from the jump (the sentinels park them
    where dilate ignores them) — a silhouette against missing depth needs
    no edge pixel because the invalid gap itself already separates the
    connected components."""
    big = np.where(valid, depth_m, -1e6).astype(np.float32)
    small = np.where(valid, depth_m, 1e6).astype(np.float32)
    dmax = dilate(big, 3)
    dmin = -dilate(-small, 3)
    jump = dmax - dmin
    thresh = np.maximum(jump_abs, jump_rel * depth_m)
    # the sentinel signs make dilate (a local max) IGNORE invalid pixels:
    # -1e6 never wins the max, +1e6 never wins the min — jump measures
    # valid neighbors only (an all-invalid window would read -2e6 and
    # correctly fail the threshold under the & valid gate)
    return valid & (jump > thresh)


def dominant_plane(points: np.ndarray, normals: np.ndarray,
                   candidates: np.ndarray, min_frac: float = 0.12,
                   angle_deg: float = 25.0, dist_m: float = 0.012
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
    """Support plane (table/floor) among `candidates`: (inlier mask, unit
    normal n0, offset d0) with the plane as {p : p.n0 = d0}, or None.

    Modal-normal voting (coarse hemisphere quantization -> refined mean)
    followed by a modal-offset histogram — a deterministic stand-in for
    RANSAC that is exact for the one dominant plane this needs."""
    idx = np.nonzero(candidates)
    if len(idx[0]) < 100:
        return None
    n = normals[idx]
    p = points[idx]
    ok = np.linalg.norm(n, axis=-1) > 0.5
    if ok.sum() < 100:
        return None
    n, p, rows = n[ok], p[ok], (idx[0][ok], idx[1][ok])
    # hemisphere: flip to z >= 0 so n and -n vote together
    flip = np.where(n[:, 2:3] < 0, -1.0, 1.0)
    nh = n * flip
    q = np.clip(((nh + 1) * 4).astype(np.int32), 0, 7)  # 8^3 bins
    bin_id = (q[:, 0] * 64 + q[:, 1] * 8 + q[:, 2])
    counts = np.bincount(bin_id, minlength=512)
    mode = int(np.argmax(counts))
    n0 = nh[bin_id == mode].mean(axis=0)
    n0 /= max(np.linalg.norm(n0), 1e-12)
    cos_tol = np.cos(np.radians(angle_deg))
    # the coarse bins split a plane's normal across neighbors, so the modal
    # bin is only a seed: iterate (align -> modal offset -> SVD refit); the
    # fit converges on the true support plane in 2-3 rounds
    d0 = None
    for _ in range(3):
        aligned = np.abs(nh @ n0) > cos_tol
        if aligned.sum() < 100:
            return None
        d = p[aligned] @ n0
        hb = np.round(d / 0.01).astype(np.int64)  # modal offset at 1 cm
        vals, cnts = np.unique(hb, return_counts=True)
        d0 = float(vals[np.argmax(cnts)]) * 0.01
        sel = aligned & (np.abs(p @ n0 - d0) < max(dist_m, 0.015))
        if sel.sum() < 100:
            return None
        pp = p[sel]
        cen = pp.mean(axis=0)
        _, _, vt = np.linalg.svd(pp - cen, full_matrices=False)
        n0 = vt[2] / max(np.linalg.norm(vt[2]), 1e-12)
        d0 = float(cen @ n0)
    inlier = (np.abs(nh @ n0) > cos_tol) & (np.abs(p @ n0 - d0) < dist_m)
    if inlier.sum() < min_frac * len(n):
        return None
    mask = np.zeros(points.shape[:2], bool)
    mask[rows[0][inlier], rows[1][inlier]] = True
    # orient n0 so that the camera (origin) is on the positive side —
    # "above the table" then always means h = p.n0 - d0 < 0 flipped to > 0
    if d0 > 0:
        n0, d0 = -n0, -d0
    return mask, n0, float(d0)


def propose_instances(
    depth_m: np.ndarray,
    intrinsics: np.ndarray,
    scale_range: Optional[Tuple[float, float]] = None,
    band: Tuple[float, float] = (0.15, 3.0),
    min_pixels: int = 300,
    max_instances: int = 5,
) -> List[np.ndarray]:
    """Segment instance-mask proposals from depth alone.

    Pipeline: depth band -> discontinuity edges -> dominant-plane removal ->
    connected components -> scale-prior gating/ranking. Returns up to
    `max_instances` boolean masks, best first. `scale_range` is the
    category's metric max-extent range (CategoryConfig.scale_range); without
    it, components rank by pixel count alone."""
    valid = (depth_m > band[0]) & (depth_m < band[1])
    if not valid.any():
        return []
    points = backproject_grid(depth_m, intrinsics)
    normals = grid_normals(points, valid)
    edges = depth_edges(depth_m, valid)
    interior = valid & ~edges
    plane = dominant_plane(points, normals, interior)
    if plane is not None:
        plane_mask, n0, d0 = plane
        pl_pts = points[plane_mask]
        # in-plane footprint bbox: support contact is only meaningful where
        # the plane actually is, not on its infinite extension
        basis = np.linalg.svd(np.eye(3) - np.outer(n0, n0))[0][:, :2]
        pl_cen = pl_pts.mean(axis=0)
        uv = (pl_pts - pl_cen) @ basis
        uv_lo, uv_hi = uv.min(axis=0) - 0.05, uv.max(axis=0) + 0.05
        # grow the plane so its rim doesn't bridge adjacent objects: the
        # pixels where an object meets its support are near-plane and would
        # otherwise connect everything standing on the table (measured on
        # example_data: 3x3 leaves a 22k-px drill+banana+bottle blob, 7x7
        # separates the drill cleanly at IoU 0.60 vs the shipped mask)
        grown = dilate(plane_mask.astype(np.uint8), 7) > 0
        interior = interior & ~grown

    n_comp, labels = connected_components(interior.astype(np.uint8), connectivity=4)
    if n_comp <= 1:
        return []
    sizes = np.bincount(labels.ravel(), minlength=n_comp)
    scored = []
    for comp in range(1, n_comp):
        if sizes[comp] < min_pixels:
            continue
        comp_mask = labels == comp
        pts = points[comp_mask]
        ext = float((pts.max(0) - pts.min(0)).max())
        if scale_range is not None:
            lo, hi = scale_range
            if not (0.4 * lo <= ext <= 2.5 * hi):
                continue
            mid = np.sqrt(lo * hi)
            prior = np.exp(-abs(np.log(max(ext, 1e-6) / mid)))
        else:
            prior = 1.0
        support = 1.0
        if plane is not None:
            # instances rest ON the support: they touch the plane level
            # (within the rim the 7x7 dilation removed), stand above it, and
            # sit inside its footprint — background clutter floats or hangs
            # below and gets demoted, not dropped (plane-less scenes and
            # held objects must still segment)
            h = pts @ n0 - d0
            c = pts.mean(axis=0)
            cuv = (c - pl_cen) @ basis
            touches = np.abs(h).min() < 0.03
            above = h.max() > 0.0
            inside = bool(np.all(cuv > uv_lo) and np.all(cuv < uv_hi))
            support = 1.0 if (touches and above and inside) else 0.15
        # close pinholes the edge detector punched into the surface; the
        # depth band keeps the closing from annexing rim pixels that lie on
        # the background behind the instance's silhouette
        zmin, zmax = float(pts[:, 2].min()), float(pts[:, 2].max())
        closed = morph_close(comp_mask.astype(np.uint8), 5).astype(bool)
        closed &= valid & (depth_m > zmin - 0.03) & (depth_m < zmax + 0.03)
        # sqrt(size): favor substantial components without letting a huge
        # scale-compatible background blob drown a well-fitting instance
        scored.append((prior * support * np.sqrt(sizes[comp]), closed))
    scored.sort(key=lambda t: -t[0])
    return [m for _, m in scored[:max_instances]]


def resolve_scale_range(
    category: Optional[str], scale_range: Optional[Tuple[float, float]]
) -> Optional[Tuple[float, float]]:
    """Category -> scale prior lookup (`config.py::CATEGORIES`); an explicit
    `scale_range` overrides it (custom objects). Shared by `auto_mask` and
    the demo's `auto_instance_mask` so the prior logic cannot drift."""
    if scale_range is None and category is not None:
        from cppf2_torch.config import CATEGORIES

        if category in CATEGORIES:
            return CATEGORIES[category].scale_range
    return scale_range


def auto_mask(
    depth_m: np.ndarray,
    intrinsics: np.ndarray,
    category: Optional[str] = None,
    scale_range: Optional[Tuple[float, float]] = None,
    band: Tuple[float, float] = (0.15, 3.0),
) -> Optional[np.ndarray]:
    """Best single instance mask for a frame, or None."""
    scale_range = resolve_scale_range(category, scale_range)
    props = propose_instances(depth_m, intrinsics, scale_range, band=band)
    return props[0] if props else None
