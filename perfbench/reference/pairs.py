"""Point-pair vote parameterization (counterpart of `cppf2_tpu/core/pairs.py`).

Every (a, b) pair is described, w.r.t. a center and the canonical axes, by
its signed projection length, its orthogonal distance from the center and
the angle of its unit direction to each axis (reference dataset.py:118-135).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from perfbench.reference.geometry import norm
from perfbench.reference.device import device_constant

_EPS = 1e-7


class PairTargets(NamedTuple):
    tr: torch.Tensor           # (N, 2): [proj_len, odist]
    up_angle: torch.Tensor     # (N,)
    right_angle: torch.Tensor  # (N,)
    front_angle: torch.Tensor  # (N,)


def pair_targets(
    a: torch.Tensor,
    b: torch.Tensor,
    up: torch.Tensor,
    right: torch.Tensor,
    front: torch.Tensor,
    center: Optional[torch.Tensor] = None,
) -> PairTargets:
    """Vote targets for pairs (a, b), (N, 3) each; axes and center are (3,)."""
    if center is None:
        center = torch.zeros(3, dtype=a.dtype, device=a.device)
    pdist = a - b
    unit = pdist / (norm(pdist, keepdim=True) + _EPS)
    rel = a - center
    proj_len = torch.sum(rel * unit, dim=-1)
    oc = rel - proj_len[..., None] * unit
    odist = norm(oc)
    tr = torch.stack([proj_len, odist], dim=-1)

    def _angle(axis):
        return torch.arccos(torch.clamp(torch.sum(unit * axis, dim=-1), -1.0, 1.0))

    return PairTargets(tr, _angle(up), _angle(right), _angle(front))


def tuple_pairwise_diffs(points: torch.Tensor, tuple_idx: torch.Tensor) -> torch.Tensor:
    """All pairwise coordinate differences within each point tuple
    (reference train_shot.py:81 / train_dino.py:92): points (N, 3), tuple
    indices (T, k) -> (T, C(k, 2) * 3), pairs in
    itertools.combinations(range(k), 2) order."""
    gathered = points[tuple_idx]
    ii, jj = _comb_indices(tuple_idx.shape[-1])
    diffs = gathered[:, list(ii), :] - gathered[:, list(jj), :]
    return diffs.reshape(diffs.shape[0], -1)


def _comb_indices(k: int):
    """Index lists (ii, jj) of itertools.combinations(range(k), 2)."""
    ii, jj = [], []
    for i in range(k):
        for j in range(i + 1, k):
            ii.append(i)
            jj.append(j)
    return tuple(ii), tuple(jj)


def comb_index_tensors(k: int, device):
    """`_comb_indices(k)` as two int64 tensors on `device`, built once: a
    tuple of ints as an index is a host-to-device copy at every use."""
    return tuple(device_constant(("comb", k, w), lambda w=w: torch.tensor(_comb_indices(k)[w]), device)
                 for w in (0, 1))
