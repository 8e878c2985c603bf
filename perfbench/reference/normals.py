"""Neighborhood normal estimation (counterpart of `cppf2_tpu/ops/normals.py`;
reference src_shot/shot.cpp:12-42): smallest-eigenvalue eigenvector of the
neighbor covariance, flipped toward the viewpoint; zero where fewer than 3
neighbors are valid."""

from __future__ import annotations

from typing import Optional

import torch

from perfbench.reference.eig3 import sym_eig3x3
from perfbench.reference.neighbors import Neighbors


def estimate_normals(points: torch.Tensor, neighbors: Neighbors,
                     viewpoint: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 3) unit normals from a fixed-K neighborhood; zero rows where
    under-determined."""
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=points.dtype, device=points.device)
    rel = neighbors.rel
    w = neighbors.valid.to(points.dtype)
    cnt = torch.sum(w, dim=-1, keepdim=True)
    rel_mean = torch.sum(rel * w[..., None], dim=-2) / torch.clamp(cnt, min=1.0)
    d = (rel - rel_mean[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", d, d)
    _, vecs = sym_eig3x3(cov)
    normal = vecs[..., 2]
    to_vp = viewpoint[None, :] - points
    flip = torch.sum(normal * to_vp, dim=-1, keepdim=True) < 0
    normal = torch.where(flip, -normal, normal)
    ok = (cnt[..., 0] >= 3)[:, None]
    return torch.where(ok, normal, torch.zeros_like(normal))
