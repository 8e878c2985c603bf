"""Fixed-shape voxel-grid downsampling (counterpart of `cppf2_tpu/core/downsample.py`).

One uniformly random point per occupied voxel (reference utils/util.py:39-46,
dataset.py:108-115): points are keyed by voxel, sorted under a random
tiebreak, and the first point of each run of equal keys is kept. When more
voxels are occupied than the budget, a uniformly random subset is kept.

The two random inputs are injected: `perm`, a permutation of the N input
points, and `prio`, N uniform priorities. `draw_downsample` draws them from a
torch.Generator; the tests pass the exact numbers `jax.random` drew.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_GRID = 1024


class Downsampled(NamedTuple):
    indices: torch.Tensor  # ([B,] m_max) int64 indices into the input cloud
    valid: torch.Tensor    # ([B,] m_max) bool
    count: torch.Tensor    # ([B]) int64 number of occupied voxels


def draw_downsample(n: int, device, generator: Optional[torch.Generator] = None):
    """(perm, prio) for `voxel_downsample` over n input points."""
    perm = torch.randperm(n, generator=generator, device=device)
    prio = torch.rand(n, generator=generator, device=device)
    return perm, prio


def _stable_topk_desc(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values of each row, ties to the lower index
    (lax.top_k)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def voxel_downsample(
    points: torch.Tensor,
    valid: torch.Tensor,
    res: float,
    m_max: int,
    perm: torch.Tensor,
    prio: torch.Tensor,
) -> Downsampled:
    """Select one random point per occupied `res`-sized voxel.

    Args:
        points: (N, 3); valid: (N,) bool.
        res: voxel edge (meters); m_max: static output budget.
        perm: (N,) permutation of range(N) (random tiebreak within a voxel).
        prio: (N,) float32 uniform priorities (random subset on overflow).

    A leading (B,) axis on every input gives B independent rows: each row
    sorts and picks its own voxels (stable sorts, so a row is the single
    call's result exactly).
    """
    if points.dim() == 2:
        one = voxel_downsample(points[None], valid[None], res, m_max, perm[None], prio[None])
        return Downsampled(*(f[0] for f in one))
    b, n = points.shape[:2]
    dev = points.device
    inf = torch.full((), float("inf"), dtype=points.dtype, device=dev)
    origin = torch.amin(torch.where(valid[..., None], points, inf), dim=1, keepdim=True)
    origin = torch.where(torch.isfinite(origin), origin, torch.zeros_like(origin))
    cell = torch.clamp(torch.floor((points - origin) / res), 0, _GRID - 1).to(torch.int64)
    cell_key = (cell[..., 0] * _GRID + cell[..., 1]) * _GRID + cell[..., 2]
    sentinel = _GRID * _GRID * _GRID
    cell_key = torch.where(valid, cell_key, torch.full_like(cell_key, sentinel))

    perm = perm.to(torch.int64)
    keys_perm = torch.gather(cell_key, 1, perm)
    sorted_keys, order_within = torch.sort(keys_perm, dim=1, stable=True)
    sorted_orig_idx = torch.gather(perm, 1, order_within)

    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[:, 1:] = sorted_keys[:, 1:] != sorted_keys[:, :-1]
    first = first & (sorted_keys < sentinel)
    count = torch.sum(first, dim=1)
    score = torch.where(first, prio, torch.full_like(prio, -1.0))
    sel_pos = _stable_topk_desc(score, min(m_max, n))
    if n < m_max:
        sel_pos = torch.cat([sel_pos, sel_pos.new_zeros(b, m_max - n)], dim=1)
    out_valid = torch.arange(m_max, device=dev) < torch.clamp(count, max=m_max)[:, None]
    indices = torch.where(out_valid, torch.gather(sorted_orig_idx, 1, sel_pos),
                          torch.zeros_like(sel_pos))
    return Downsampled(indices, out_valid, count)
