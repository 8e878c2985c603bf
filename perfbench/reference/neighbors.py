"""Fixed-K radius-bounded nearest neighbors (counterpart of
`cppf2_tpu/ops/neighbors.py`; reference src_shot/shot.cpp:28,70,139).

Selection is on the same packed key as the JAX default path:
round(clip(d2, 0, r2) * levels / r2) * n + col, exact in float32, so the k
smallest keys name the neighbors (nearest first, ties to the lower column).
The port selects them exactly with torch.topk; the reference's
approx_min_k is exact on the CPU, where the tests compare the two.

`exact=True` is the reference's `lax.top_k(-d2, k)` route: the k smallest
unquantized d2, ties to the lower column (a stable sort, since torch.topk
leaves the order of ties undefined), and distances sqrt(max(d2, 0)) of the
selected keys instead of the norms of the offsets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference.geometry import norm
from perfbench.reference.voting import take_rows


_QUERY_CHUNK = 8192  # queries per (chunk, N) distance block
# elements of one (instances, queries, N) distance block: 2^27 f32 is 512 MB
# a live intermediate, two instances of 8192 points at once
_BLOCK_ELEMS = 1 << 27


class Neighbors(NamedTuple):
    idx: torch.Tensor    # ([B,] N, K) int64 neighbor indices, nearest first (self included)
    dist: torch.Tensor   # ([B,] N, K) float32 distances
    valid: torch.Tensor  # ([B,] N, K) bool: within radius and query valid
    rel: torch.Tensor    # ([B,] N, K, 3) neighbor - query offsets


def _sum_sq_fma(x: torch.Tensor) -> torch.Tensor:
    """x0*x0 + x1*x1 + x2*x2 as a chain of fused multiply-adds, emulated in
    float64 (the product is exact there; the sum rounds once more, which
    differs from a true fma only at an exact float32 midpoint). The packed
    keys round d2, so one ulp of a norm can move a key."""
    s = x[..., 0] * x[..., 0]
    for i in (1, 2):
        xi = x[..., i].double()
        s = (xi * xi + s.double()).float()
    return s


def as_one_cloud(points: torch.Tensor, neighbors: Neighbors):
    """A (B, N) group's clouds and neighborhoods as one (B * N) batch of
    points, each neighbor index moved into its instance's block, so the
    per-point stages (normals, LRF, SHOT) run once over the group. A single
    (N, 3) cloud passes through."""
    if points.dim() == 2:
        return points, neighbors
    b, n = points.shape[:2]
    off = torch.arange(b, device=points.device)[:, None, None] * n
    return points.reshape(b * n, 3), Neighbors(
        (neighbors.idx + off).flatten(0, 1), neighbors.dist.flatten(0, 1),
        neighbors.valid.flatten(0, 1), neighbors.rel.flatten(0, 1))


def knn_radius_neighbors(
    points: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    k: int,
    exact: bool = False,
) -> Neighbors:
    """K nearest neighbors within `radius` of every point, fixed shape.

    Invalid points are parked at 1e6 so they fail every radius test. The
    (instances, chunk, N) distance block is the only quadratic buffer.
    `exact` selects on the unquantized squared distances (module docstring).

    A leading (B,) axis gives each instance's neighbors inside its own
    cloud (the packed key depends on N, so clouds are never merged); a row
    equals the single call's result to the bit. Instances go through in
    blocks of at most `_BLOCK_ELEMS` distances."""
    if points.dim() == 2:
        return Neighbors(*(f[0] for f in knn_radius_neighbors(points[None], valid[None], radius,
                                                              k, exact)))
    b, n = points.shape[:2]
    k = min(k, n)
    query_chunk = min(_QUERY_CHUNK, max(-(-n // 256) * 256, 256))
    per_block = max(_BLOCK_ELEMS // (query_chunk * max(n, 1)), 1)
    park = torch.full((), 1e6, dtype=points.dtype, device=points.device)
    pts = torch.where(valid[..., None], points, park)
    # column and query norms as one fma chain: the rounding XLA gives both
    # under jax.jit, which is how the JAX driver runs the kNN (its
    # preprocess_frame is jitted), so the packed keys agree with that graph
    sq = _sum_sq_fma(pts)
    r2 = radius * radius
    levels = max((1 << 24) // max(n, 1) - 1, 1)
    col = torch.arange(n, dtype=torch.float32, device=points.device)

    blocks = []
    for lo in range(0, b, per_block):
        p = pts[lo:lo + per_block]
        dists, idxs, rels = [], [], []
        for start in range(0, n, query_chunk):
            q = p[:, start:start + query_chunk]
            qsq = sq[lo:lo + per_block, start:start + query_chunk]
            cross = torch.matmul(q, p.transpose(1, 2))
            d2 = qsq[..., None] + sq[lo:lo + per_block, None, :] - 2.0 * cross
            if exact:
                d2_k, idx = torch.sort(d2, dim=-1, stable=True)
                d2_k, idx = d2_k[..., :k], idx[..., :k]
                dists.append(torch.sqrt(torch.clamp(d2_k, min=0.0)))
            else:
                qd2 = torch.round(torch.clamp(d2, 0.0, r2) * (levels / r2))
                enc = qd2 * n + col
                enc_k = torch.topk(enc, k, dim=-1, largest=False, sorted=True).values
                idx = torch.remainder(enc_k, float(n)).to(torch.int64)
            diff = take_rows(p, idx) - q[:, :, None, :]
            if not exact:
                dists.append(norm(diff))
            idxs.append(idx)
            rels.append(diff)
        blocks.append([torch.cat(x, dim=1) for x in (idxs, dists, rels)])
    idx, dist, rel = (torch.cat(x) for x in zip(*blocks))
    nb_valid = (dist <= radius) & valid[..., None]
    return Neighbors(idx, dist, nb_valid, rel)
