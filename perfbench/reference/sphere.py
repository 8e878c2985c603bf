"""Weighted votes on the sphere points, plain PyTorch (a frozen copy of the
plain version beside the port's kernel K3, `cppf2_torch/ops/sphere.py`)."""

from __future__ import annotations

import math

import torch

PLAIN_CHUNK = 131072   # votes per step of the plain version, as sphere_vote chunks them


def threshold(angle_tol_deg: float) -> float:
    """cos(2 tol) as the JAX package computes it: the float32 cosine of the
    float32-rounded angle 2 * tol / 180 * pi."""
    angle = torch.tensor(2 * angle_tol_deg / 180.0 * math.pi, dtype=torch.float32)
    return float(torch.cos(angle))


def _cosine(d: torch.Tensor, sphere: torch.Tensor) -> torch.Tensor:
    """(V, 3) x (S, 3) -> (V, S) cosines, elementwise in the kernel's order."""
    return ((d[:, None, 0] * sphere[None, :, 0] + d[:, None, 1] * sphere[None, :, 1])
            + d[:, None, 2] * sphere[None, :, 2])


def sphere_accumulate_plain(dirs: torch.Tensor, weights: torch.Tensor, sphere: torch.Tensor,
                            angle_tol_deg: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, PLAIN_CHUNK votes at a time (a
    whole (900k, 720) f32 block would take 2.6 GB per intermediate)."""
    t = threshold(angle_tol_deg)
    b, v, _ = dirs.shape
    counts = torch.zeros((b, sphere.shape[0]), dtype=torch.float32, device=dirs.device)
    for i in range(b):
        for lo in range(0, v, PLAIN_CHUNK):
            d = dirs[i, lo:lo + PLAIN_CHUNK]
            w = weights[i, lo:lo + PLAIN_CHUNK]
            hits = _cosine(d, sphere) > t
            counts[i] += torch.sum(torch.where(hits, w[:, None], 0.0), dim=0)
    return counts


sphere_accumulate = sphere_accumulate_plain
