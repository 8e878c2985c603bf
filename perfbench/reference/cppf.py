"""Point-tuple voting models: geometric (SHOT) and visual (DINO) branches.

Counterpart of `cppf2_tpu/models/cppf.py` (reference train_shot.py:46-130,
train_dino.py:58-138), with the same widths and parameter names so the
weight-carry function (`models/porting.py`) maps one tree onto the other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from perfbench.reference.pairs import comb_index_tensors
from perfbench.reference.layers import Dense, ResMLP
from perfbench.reference.voting import take_rows


class TuplePredictions(NamedTuple):
    logits: torch.Tensor  # (..., T, 6, num_bins) float32
    scales: torch.Tensor  # (..., T, 3) float32


class Heads(nn.Module):
    def __init__(self, num_bins: int, compute_dtype=torch.float32):
        super().__init__()
        self.num_bins = num_bins
        self.logit_encoder = ResMLP(256, (256, 256, 6 * num_bins), compute_dtype)
        self.scale_encoder = ResMLP(256, (128, 64, 3), compute_dtype)

    def forward(self, feat: torch.Tensor) -> TuplePredictions:
        logits = self.logit_encoder(feat)
        scales = self.scale_encoder(feat)
        return TuplePredictions(
            logits.reshape(*feat.shape[:-1], 6, self.num_bins).float(), scales.float())


def _gather(x: torch.Tensor, ti: torch.Tensor) -> torch.Tensor:
    """Per-point features at the tuples' points: x (N, C) with indices of any
    shape, or a group's x (B, N, C) with indices (B, ...), each row's own."""
    return x[ti] if x.dim() == 2 else take_rows(x, ti)


def _pair_coords(g_pts: torch.Tensor, k: int) -> torch.Tensor:
    ii, jj = comb_index_tensors(k, g_pts.device)
    return (g_pts[..., ii, :] - g_pts[..., jj, :]).flatten(-2)


class ShotBranch(nn.Module):
    """Geometric branch over SHOT descriptors and normals.

    `forward(points, shot, normals, tuple_idx)`: one cloud (N, ...) with
    tuples (T, k) or (R, T, k), or a group (B, N, ...) with (B, T, k); the
    per-point encoder runs once a cloud and the tuple encoder once over
    every tuple, so a group or a restart axis is one forward."""

    def __init__(self, tuple_size: int = 5, num_bins: int = 32, shot_dim: int = 352,
                 compute_dtype=torch.float32):
        super().__init__()
        self.tuple_size = tuple_size
        n_pairs = tuple_size * (tuple_size - 1) // 2
        self.shot_encoder = ResMLP(shot_dim, (128,) * 5 + (64,), compute_dtype)
        self.tuple_encoder = ResMLP(
            n_pairs * 4 + tuple_size * 64, (128,) * 5 + (256,), compute_dtype)
        self.heads = Heads(num_bins, compute_dtype)

    def forward(self, points, shot, normals, tuple_idx) -> TuplePredictions:
        k = self.tuple_size
        ii, jj = comb_index_tensors(k, points.device)
        enc = self.shot_encoder(shot)                       # (..., N, 64)
        ti = tuple_idx.long()
        g_pts, g_enc, g_nrm = _gather(points, ti), _gather(enc, ti), _gather(normals, ti)
        ncos = torch.abs(torch.sum(g_nrm[..., ii, :] * g_nrm[..., jj, :], dim=-1))
        feats = torch.cat([_pair_coords(g_pts, k), ncos, g_enc.flatten(-2).float()], dim=-1)
        return self.heads(self.tuple_encoder(feats))


class DinoBranch(nn.Module):
    """Visual branch over DINOv2 patch descriptors; shapes as `ShotBranch`."""

    def __init__(self, tuple_size: int = 5, num_bins: int = 32, desc_dim: int = 1024,
                 proj_dim: int = 256, compute_dtype=torch.float32):
        super().__init__()
        self.tuple_size = tuple_size
        n_pairs = tuple_size * (tuple_size - 1) // 2
        self.desc_transform = Dense(desc_dim, proj_dim, compute_dtype)
        self.desc_pair_transform = Dense(tuple_size * proj_dim, proj_dim, compute_dtype)
        self.tuple_encoder = ResMLP(n_pairs * 3 + proj_dim, (128,) * 5 + (256,), compute_dtype)
        self.heads = Heads(num_bins, compute_dtype)

    def forward(self, points, desc, tuple_idx) -> TuplePredictions:
        ti = tuple_idx.long()
        pdesc = self.desc_transform(desc)                   # (..., N, 256)
        pair_desc = self.desc_pair_transform(_gather(pdesc, ti).flatten(-2))
        feats = torch.cat([_pair_coords(_gather(points, ti), self.tuple_size), pair_desc.float()],
                          dim=-1)
        return self.heads(self.tuple_encoder(feats))
