"""Fixed-K radius-bounded nearest neighbors (counterpart of
`cppf2_tpu/ops/neighbors.py`; reference src_shot/shot.cpp:28,70,139).

Selection is on the same packed key as the JAX default path:
round(clip(d2, 0, r2) * levels / r2) * n + col, exact in float32, so the k
smallest keys name the neighbors (nearest first, ties to the lower column).
The reference's approx_min_k is exact on the CPU, where the tests compare the
two.

On the card the selection is kernel K6 (`knn_select`, `csrc/knn.cu`): the
keys made and each row's k smallest kept on chip, only the (B, N, k) indices
written. On the CPU it is the plain route: the (B, chunk, N) block of keys
and torch.topk. Both take the cross product as the fma chain
fma(z, z', fma(y, y', x * x')): what cuBLAS's K = 3 float32 product gives on
the card (TF32 off) and MKL's on the CPU, so the kernel and the plain route
select the same integers. `knn_select_plain` is the kernel's arithmetic and
selection in plain PyTorch, the keys made a column tile at a time and merged
into a running k smallest.

`exact=True` is the reference's `lax.top_k(-d2, k)` route: the k smallest
unquantized d2, ties to the lower column (a stable sort, since torch.topk
leaves the order of ties undefined), and distances sqrt(max(d2, 0)) of the
selected keys instead of the norms of the offsets. It keeps the plain route
on the card too.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cppf2_torch.core.geometry import norm
from cppf2_torch.ops import _build
from cppf2_torch.ops.voting import take_rows


_QUERY_CHUNK = 8192  # queries per (chunk, N) distance block
# elements of one (instances, queries, N) distance block: 2^27 f32 is 512 MB
# a live intermediate, two instances of 8192 points at once
_BLOCK_ELEMS = 1 << 27
_PLAIN_TILE = 1024  # queries and columns of one step of `knn_select_plain`
MAX_KERNEL_K = 128  # K6 keeps at most 4 keys a lane of a warp

SOURCE = "cppf2_torch/csrc/knn.cu"
REPLACES = None   # no TPU kernel: the JAX package leaves the selection to XLA's approx_min_k


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


def _key_scale(n: int, radius: float):
    """(r2, the key's scale levels / r2) of a cloud of n points: the key's
    levels fill float32's 2^24 integers with the n columns."""
    r2 = radius * radius
    levels = max((1 << 24) // max(n, 1) - 1, 1)
    return r2, levels / r2


def _cross_fma(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, Q, 3) x (B, C, 3) -> (B, Q, C): fma(z, z', fma(y, y', x * x')),
    each fma emulated in float64 as in `_sum_sq_fma`."""
    s = q[:, :, None, 0] * c[:, None, :, 0]
    for i in (1, 2):
        s = (q[:, :, None, i].double() * c[:, None, :, i].double() + s.double()).float()
    return s


def knn_select_plain(pts: torch.Tensor, sq: torch.Tensor, radius: float, k: int) -> torch.Tensor:
    """K6's arithmetic and selection in plain PyTorch: (B, N, k) int64
    columns of each query's k smallest packed keys over its own cloud,
    nearest first. `pts` (B, N, 3) float32 with invalid points parked, `sq`
    its `_sum_sq_fma` norms. The keys are made a column tile at a time and
    merged into a running k smallest (they are distinct integers, so the
    merge needs no tie rule)."""
    b, n = pts.shape[:2]
    r2, scale = _key_scale(n, radius)
    col = torch.arange(n, dtype=torch.float32, device=pts.device)
    rows = []
    for start in range(0, n, _PLAIN_TILE):
        q, qsq = pts[:, start:start + _PLAIN_TILE], sq[:, start:start + _PLAIN_TILE]
        best = torch.full((b, q.shape[1], 0), float("inf"), device=pts.device)
        for lo in range(0, n, _PLAIN_TILE):
            d2 = (qsq[..., None] + sq[:, None, lo:lo + _PLAIN_TILE]) \
                - 2.0 * _cross_fma(q, pts[:, lo:lo + _PLAIN_TILE])
            keys = torch.round(torch.clamp(d2, 0.0, r2) * scale) * n + col[lo:lo + _PLAIN_TILE]
            merged = torch.cat([best, keys], dim=-1)
            best = torch.topk(merged, min(k, merged.shape[-1]), dim=-1, largest=False,
                              sorted=True).values
        rows.append(torch.remainder(best, float(n)).to(torch.int64))
    return torch.cat(rows, dim=1)


def _check_select(pts: torch.Tensor, sq: torch.Tensor, k: int) -> None:
    """What K6 takes: float32 (B, N, 3) points and (B, N) norms, 1 <= k <=
    min(N, 128). It raises on anything else: there is no fallback to the
    plain route."""
    if pts.dtype != torch.float32 or sq.dtype != torch.float32:
        raise ValueError(f"the kNN kernel takes float32 points and norms, got {pts.dtype} and "
                         f"{sq.dtype}")
    if pts.dim() != 3 or pts.shape[-1] != 3 or tuple(sq.shape) != tuple(pts.shape[:2]):
        raise ValueError(f"the kNN kernel takes (B, N, 3) points and (B, N) norms, got "
                         f"{tuple(pts.shape)} and {tuple(sq.shape)}")
    if not 1 <= k <= min(pts.shape[1], MAX_KERNEL_K):
        raise ValueError(f"the kNN kernel keeps 1 to {MAX_KERNEL_K} neighbors, at most N = "
                         f"{pts.shape[1]}, got k = {k}")


def knn_select(pts: torch.Tensor, sq: torch.Tensor, radius: float, k: int) -> torch.Tensor:
    """Kernel K6: `knn_select_plain`'s (B, N, k) int64 columns in one launch
    on a CUDA tensor, for every instance at once."""
    _check_select(pts, sq, k)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}: the kNN kernel runs on a CUDA card")
    pts, sq = pts.contiguous(), sq.contiguous()
    b, n = pts.shape[:2]
    r2, scale = _key_scale(n, radius)
    out = torch.empty((b, n, k), dtype=torch.int64, device=pts.device)
    _build.launch("knn", "cppf2_knn_select",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                  + [ctypes.c_void_p], pts.device,
                  pts.data_ptr(), sq.data_ptr(), out.data_ptr(), b, n, k, r2, scale)
    return out


def _plain_neighbors(pts: torch.Tensor, sq: torch.Tensor, radius: float, k: int, exact: bool):
    """The plain route: (idx, dist, rel) from (instances, chunk, N) blocks of
    keys (or of d2, `exact`), instances in blocks of at most `_BLOCK_ELEMS`
    distances."""
    b, n = pts.shape[:2]
    query_chunk = min(_QUERY_CHUNK, max(-(-n // 256) * 256, 256))
    per_block = max(_BLOCK_ELEMS // (query_chunk * max(n, 1)), 1)
    r2, scale = _key_scale(n, radius)
    col = torch.arange(n, dtype=torch.float32, device=pts.device)

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
                qd2 = torch.round(torch.clamp(d2, 0.0, r2) * scale)
                enc = qd2 * n + col
                enc_k = torch.topk(enc, k, dim=-1, largest=False, sorted=True).values
                idx = torch.remainder(enc_k, float(n)).to(torch.int64)
            diff = take_rows(p, idx) - q[:, :, None, :]
            if not exact:
                dists.append(norm(diff))
            idxs.append(idx)
            rels.append(diff)
        blocks.append([torch.cat(x, dim=1) for x in (idxs, dists, rels)])
    return tuple(torch.cat(x) for x in zip(*blocks))


def knn_radius_neighbors(
    points: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    k: int,
    exact: bool = False,
) -> Neighbors:
    """K nearest neighbors within `radius` of every point, fixed shape.

    Invalid points are parked at 1e6 so they fail every radius test.
    `exact` selects on the unquantized squared distances (module docstring).
    On a card the default route is K6 (`knn_select`, k <= 128); on the CPU,
    and for `exact`, the plain route's (instances, chunk, N) distance block
    is the only quadratic buffer.

    A leading (B,) axis gives each instance's neighbors inside its own
    cloud (the packed key depends on N, so clouds are never merged); a row
    equals the single call's result to the bit."""
    if points.dim() == 2:
        return Neighbors(*(f[0] for f in knn_radius_neighbors(points[None], valid[None], radius,
                                                              k, exact)))
    n = points.shape[1]
    k = min(k, n)
    park = torch.full((), 1e6, dtype=points.dtype, device=points.device)
    pts = torch.where(valid[..., None], points, park)
    # column and query norms as one fma chain: the rounding XLA gives both
    # under jax.jit, which is how the JAX driver runs the kNN (its
    # preprocess_frame is jitted), so the packed keys agree with that graph
    sq = _sum_sq_fma(pts)
    if exact or points.device.type == "cpu":
        idx, dist, rel = _plain_neighbors(pts, sq, radius, k, exact)
    else:
        idx = knn_select(pts, sq, radius, k)
        rel = take_rows(pts, idx) - pts[:, :, None, :]
        dist = norm(rel)
    nb_valid = (dist <= radius) & valid[..., None]
    return Neighbors(idx, dist, nb_valid, rel)
