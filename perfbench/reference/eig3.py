"""Batched closed-form symmetric 3x3 eigendecomposition (counterpart of
`cppf2_tpu/ops/eig3.py`).

The trigonometric (Cardano) solver with the reference's eigenvalue order
(descending) and eigenvector signs; torch.linalg.eigh orders and signs its
vectors differently and is not used.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from perfbench.reference.geometry import norm

_EPS = 1e-20


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def sym_eig3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigvals (..., 3) descending, eigvecs (..., 3, 3) as columns) of
    batched symmetric 3x3 matrices; the vectors form a right-handed basis."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    scale = torch.clamp(torch.amax(torch.abs(A), dim=(-2, -1)), min=_EPS)
    a00, a11, a22, a01, a02, a12 = (x / scale for x in (a00, a11, a22, a01, a02, a12))

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))

    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    diag_like = p2 < 1e-14
    eigvals = torch.stack([e1, e2, e3], dim=-1)
    diag_sorted = torch.sort(torch.stack([a00, a11, a22], dim=-1), dim=-1).values.flip(-1)
    eigvals = torch.where(diag_like[..., None], diag_sorted, eigvals)

    rows = torch.stack([
        torch.stack([a00, a01, a02], dim=-1),
        torch.stack([a01, a11, a12], dim=-1),
        torch.stack([a02, a12, a22], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)

    def eigvec_for(lam):
        m = rows - lam[..., None, None] * eye
        cands = torch.stack([_cross(m[..., 0, :], m[..., 1, :]),
                             _cross(m[..., 0, :], m[..., 2, :]),
                             _cross(m[..., 1, :], m[..., 2, :])], dim=-2)
        norms = torch.sum(cands * cands, dim=-1)
        best = torch.argmax(norms, dim=-1)
        v = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
        nv = norm(v, keepdim=True)
        return v / torch.clamp(nv, min=_EPS), nv[..., 0]

    v1, n1 = eigvec_for(e1)
    v3, n3 = eigvec_for(e3)
    ex = torch.zeros_like(v1)
    ex[..., 0].fill_(1.0)   # a fill, not an assignment, which makes a tensor of the number first
    ez = torch.zeros_like(v3)
    ez[..., 2].fill_(1.0)
    v1 = torch.where((n1 < 1e-10)[..., None], ex, v1)
    v3 = torch.where((n3 < 1e-10)[..., None], ez, v3)
    v3 = v3 - torch.sum(v3 * v1, dim=-1, keepdim=True) * v1
    v3n = norm(v3, keepdim=True)
    v3_fb = _cross(v1, torch.where(torch.abs(v1[..., :1]) < 0.9, ex, ez))
    v3_fb = v3_fb / torch.clamp(norm(v3_fb, keepdim=True), min=_EPS)
    v3 = torch.where(v3n < 1e-10, v3_fb, v3 / torch.clamp(v3n, min=_EPS))
    v2 = _cross(v3, v1)
    return eigvals * scale[..., None], torch.stack([v1, v2, v3], dim=-1)
