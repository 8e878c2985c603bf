"""SHOT-352 local descriptor (counterpart of `cppf2_tpu/ops/shot.py`;
reference src_shot/shot.cpp:45-100 through PCL, radii cfg.res * 10).

The descriptor is assembled as a dense product of soft binning weights,
desc[n, v, c] = sum_k Wspatial[n, k, v] * Wcos[n, k, c], over 32 spatial
volumes (8 azimuth x 2 elevation x 2 radial) and 11 cosine bins. The colour
variant (CSHOT-1344, reference src_shot/shot.cpp:102-161) adds 31 bins of
CIELAB colour distance per volume, on the same spatial weights.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.geometry import norm
from perfbench.reference.device import device_constant
from perfbench.reference.eig3 import sym_eig3x3
from perfbench.reference.neighbors import Neighbors, as_one_cloud, knn_radius_neighbors
from perfbench.reference.normals import estimate_normals

_EPS = 1e-12

N_AZIMUTH = 8
N_ELEVATION = 2
N_RADIAL = 2
N_COS_BINS = 11
SHOT_DIM = N_AZIMUTH * N_ELEVATION * N_RADIAL * N_COS_BINS  # 352


def shot_lrf(points: torch.Tensor, neighbors: Neighbors, radius: float) -> torch.Tensor:
    """(N, 3, 3) local reference frames, rows [x, y, z]."""
    rel = neighbors.rel
    w = torch.clamp(radius - neighbors.dist, min=0.0) * neighbors.valid
    wsum = torch.sum(w, dim=-1, keepdim=True)
    cov = torch.einsum("nk,nki,nkj->nij", w, rel, rel) / torch.clamp(wsum[..., None], min=_EPS)
    _, vecs = sym_eig3x3(cov)
    x, z = vecs[..., 0], vecs[..., 2]

    def disamb(axis):
        proj = torch.sum(rel * axis[:, None, :], dim=-1)
        vote = torch.where(proj >= 0, 1.0, -1.0)
        score = torch.sum(torch.where(neighbors.valid, vote, torch.zeros_like(vote)), dim=-1)
        return axis * torch.where(score >= 0, 1.0, -1.0)[:, None]

    x, z = disamb(x), disamb(z)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-2)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    # F.one_hot's values, without the range checks it reads back from a CPU tensor
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _soft_bins_centers_half(u: torch.Tensor, n_bins: int, circular: bool) -> torch.Tensor:
    """Linear soft binning of u in [0, n_bins], bin centers at i + 0.5."""
    shifted = u - 0.5
    i0f = torch.floor(shifted)
    frac = shifted - i0f
    i0 = i0f.to(torch.int64)
    if circular:
        b0, b1 = torch.remainder(i0, n_bins), torch.remainder(i0 + 1, n_bins)
    else:
        b0, b1 = torch.clamp(i0, 0, n_bins - 1), torch.clamp(i0 + 1, 0, n_bins - 1)
    return (_one_hot(b0, n_bins, u.dtype) * (1.0 - frac)[..., None]
            + _one_hot(b1, n_bins, u.dtype) * frac[..., None])


def _soft_bins_centers_int(u: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Linear soft binning of u in [0, n_bins - 1], centers at integers."""
    i0f = torch.floor(u)
    frac = u - i0f
    i0 = i0f.to(torch.int64)
    b0, b1 = torch.clamp(i0, 0, n_bins - 1), torch.clamp(i0 + 1, 0, n_bins - 1)
    return (_one_hot(b0, n_bins, u.dtype) * (1.0 - frac)[..., None]
            + _one_hot(b1, n_bins, u.dtype) * frac[..., None])


def _lrf_spatial_weights(points, neighbors: Neighbors, radius: float):
    """LRF frames and the (N, K, 32) soft spatial-binning weights."""
    frames = shot_lrf(points, neighbors, radius)
    local = torch.einsum("nab,nkb->nka", frames, neighbors.rel)
    d = neighbors.dist
    safe_d = torch.clamp(d, min=_EPS)
    azimuth = torch.atan2(local[..., 1], local[..., 0])
    a_cont = (azimuth + math.pi) / (2.0 * math.pi) * N_AZIMUTH
    cos_incl = torch.clamp(local[..., 2] / safe_d, -1.0, 1.0)
    e_cont = 1.0 - cos_incl
    r_cont = torch.clamp(d / (radius / 2.0), 0.0, 2.0)
    A = _soft_bins_centers_half(a_cont, N_AZIMUTH, circular=True)
    E = _soft_bins_centers_half(e_cont, N_ELEVATION, circular=False)
    R = _soft_bins_centers_half(r_cont, N_RADIAL, circular=False)
    w_spatial = torch.einsum("nka,nke,nkr->nkaer", A, E, R).reshape(
        A.shape[0], A.shape[1], N_AZIMUTH * N_ELEVATION * N_RADIAL)
    return frames, w_spatial


def compute_shot(points: torch.Tensor, normals: torch.Tensor, neighbors: Neighbors,
                 radius: float, _lrf_spatial=None) -> torch.Tensor:
    """(N, 352) SHOT descriptors, L2-normalized per point (zero rows when
    empty). `_lrf_spatial`: a precomputed `_lrf_spatial_weights` result
    (`compute_cshot` shares it between its two halves)."""
    frames, w_spatial = (_lrf_spatial if _lrf_spatial is not None
                         else _lrf_spatial_weights(points, neighbors, radius))
    d = neighbors.dist
    nb_normal = normals[neighbors.idx]
    has_normal = torch.sum(nb_normal * nb_normal, dim=-1) > 0.5
    contrib = neighbors.valid & (d > _EPS) & has_normal
    cw = contrib.to(points.dtype)
    cosine = torch.clamp(torch.sum(nb_normal * frames[:, None, 2, :], dim=-1), -1.0, 1.0)
    c_cont = (1.0 + cosine) * (N_COS_BINS - 1) / 2.0
    C = _soft_bins_centers_int(c_cont, N_COS_BINS)
    desc = torch.einsum("nkv,nkc->nvc", w_spatial * cw[..., None], C).reshape(-1, SHOT_DIM)
    dn = norm(desc, keepdim=True)
    return torch.where(dn > _EPS, desc / torch.clamp(dn, min=_EPS), torch.zeros_like(desc))


def compute_shot_features(points: torch.Tensor, valid: torch.Tensor, radius: float, k: int = 96,
                          exact: bool = False):
    """Normals and SHOT in one call (the reference's shot.compute with
    normal_r == shot_r). Returns (shot (N, 352), normals (N, 3)). `exact`
    is the kNN's exact route. A leading (B,) axis takes each instance's
    neighbors in its own cloud, then runs the per-point stages once over
    the group's B * N points (`as_one_cloud`)."""
    pts, nbrs = as_one_cloud(points, knn_radius_neighbors(points, valid, radius, k, exact=exact))
    normals = estimate_normals(pts, nbrs)
    shot = compute_shot(pts, normals, nbrs, radius)
    return shot.reshape(*points.shape[:-1], SHOT_DIM), normals.reshape(points.shape)


# --- CSHOT (colour SHOT-1344) ------------------------------------------------

N_COLOR_BINS = 31           # PCL nr_color_bins=30 -> 31 slots per volume
CSHOT_DIM = SHOT_DIM + N_AZIMUTH * N_ELEVATION * N_RADIAL * N_COLOR_BINS  # 1344

_RGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
               (0.212671, 0.715160, 0.072169),
               (0.019334, 0.119193, 0.950227))


def _constant(values, like: torch.Tensor) -> torch.Tensor:
    return device_constant(("shot", values, like.dtype),
                           lambda: torch.tensor(values, dtype=like.dtype), like.device)


def _rgb_to_cielab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] -> CIELAB (D65), PCL's RGB2CIELAB. The cube root is
    pow(x, 1/3) on the branch where x > 0.008856."""
    c = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    m = _constant(_RGB_TO_XYZ, rgb)
    xyz = c @ m.t()
    xyz = xyz / _constant((0.95047, 1.0, 1.08883), rgb)
    f = torch.where(xyz > 0.008856, torch.pow(torch.clamp(xyz, min=0.008856), 1.0 / 3.0),
                    7.787 * xyz + 16.0 / 116.0)
    lab_l = 116.0 * f[..., 1] - 16.0
    lab_a = 500.0 * (f[..., 0] - f[..., 1])
    lab_b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([lab_l, lab_a, lab_b], dim=-1)


def compute_cshot(points: torch.Tensor, colors: torch.Tensor, normals: torch.Tensor,
                  neighbors: Neighbors, radius: float) -> torch.Tensor:
    """(N, 1344) colour SHOT, the reference's `shot.compute_color` (PCL
    SHOTColorEstimation): the 352 shape values, then 32 volumes x 31 bins of
    the CIELAB distance |lab_q - lab_p| / 3 (per channel over the ranges
    100, 120, 120) between each neighbour and the point, on the shape half's
    spatial weights; every in-radius neighbour feeds the colour half, with
    no normal test. The 1344 values are L2-normalized jointly (zero rows
    when empty). `colors`: (N, 3) RGB in [0, 1], or a group's (B, N / B, 3)
    when `points` are the group's clouds as one batch (`as_one_cloud`): each
    cloud's colours convert alone, since the conversion's powers and product
    round an element otherwise when the number of points around it changes."""
    lrf_spatial = _lrf_spatial_weights(points, neighbors, radius)
    shape_desc = compute_shot(points, normals, neighbors, radius, _lrf_spatial=lrf_spatial)
    _, w_spatial = lrf_spatial
    contrib = neighbors.valid & (neighbors.dist > _EPS)
    cw = contrib.to(points.dtype)
    lab = (torch.cat([_rgb_to_cielab(c) for c in colors]) if colors.dim() == 3
           else _rgb_to_cielab(colors))
    lab_n = lab / _constant((100.0, 120.0, 120.0), points)
    cdist = torch.sum(torch.abs(lab_n[neighbors.idx] - lab_n[:, None, :]), dim=-1) / 3.0
    c_cont = torch.clamp(cdist, 0.0, 1.0) * (N_COLOR_BINS - 1)
    C = _soft_bins_centers_int(c_cont, N_COLOR_BINS)
    cdesc = torch.einsum("nkv,nkc->nvc", w_spatial * cw[..., None], C).reshape(-1, CSHOT_DIM - SHOT_DIM)
    full = torch.cat([shape_desc, cdesc], dim=-1)
    fn = norm(full, keepdim=True)
    return torch.where(fn > _EPS, full / torch.clamp(fn, min=_EPS), torch.zeros_like(full))


def compute_cshot_features(points: torch.Tensor, colors: torch.Tensor, valid: torch.Tensor,
                           radius: float, k: int = 96):
    """Normals and colour SHOT in one call, the analog of the reference's
    `shot.compute_color(pc, pc_color, normal_r, shot_r)`. Returns (cshot
    (N, 1344), normals (N, 3)); a leading (B,) axis as in
    `compute_shot_features`."""
    pts, nbrs = as_one_cloud(points, knn_radius_neighbors(points, valid, radius, k))
    normals = estimate_normals(pts, nbrs)
    cshot = compute_cshot(pts, colors, normals, nbrs, radius)
    return cshot.reshape(*points.shape[:-1], CSHOT_DIM), normals.reshape(points.shape)
